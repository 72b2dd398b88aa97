"""Training (port of ``repro/training``): the hand-written optimizers
(``optimizer``: ``AdamW``, ``AdamW8bit``, ``cosine_schedule``), the data
pipelines (``data``: the zoo's ``TokenStream``, the GROOT graph batch) and
the zoo's LM train step (``train_step``: ``lm_loss``, ``make_train_step``)."""
