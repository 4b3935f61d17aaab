"""The frozen plain references: plain PyTorch, importing nothing of the
program (``repro_torch``), of JAX or of the JAX package."""
