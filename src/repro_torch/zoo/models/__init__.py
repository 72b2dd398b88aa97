"""Model layers of the zoo port: shared layers, attention, the LM stack."""
