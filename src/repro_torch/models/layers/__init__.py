"""LM layers: ``norms``, ``rope``, ``embedding``, ``mlp``, ``attention``,
``moe`` (top-k routed experts) and ``spectral`` (the gated FFT
long-convolution mixer)."""
