"""Host-side design generation, features, verification, the GNN and the pipeline."""
