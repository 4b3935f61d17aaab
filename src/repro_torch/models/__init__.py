"""The LM stack's layers, ported module by module (``models.layers``)."""
