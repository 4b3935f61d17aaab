"""The decoder LM: layers, blocks, the stack and the model (``models.model``)."""
