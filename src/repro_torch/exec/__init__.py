"""Host-side partition plans (reference: ``repro/exec``); the streaming
executor is not ported yet."""
