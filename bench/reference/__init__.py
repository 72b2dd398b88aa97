"""The benchmark's plain reference: frozen design generators, GROOT's node
features and edge groups, the GNN forward, and the bfs partition with 1-hop
re-growth (``model``); a dense decoder LM and its seeded weights (``lm``); in
plain NumPy and PyTorch.  It imports nothing of the program
under test, so no change to the program can move what it computes."""
