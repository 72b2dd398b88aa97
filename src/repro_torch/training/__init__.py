"""Training of the GROOT GNN (port of the graph half of ``repro/training``):
the hand-written AdamW (``optimizer``) and the host graph batch (``data``).
The reference's int8-moment AdamW, ``make_optimizer``, ``cosine_schedule``
and ``TokenStream`` serve the zoo's training and are not ported (ROADMAP
Queue 1, item 8)."""
