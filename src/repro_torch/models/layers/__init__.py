"""LM layers: ``norms``, ``rope``, ``embedding``, ``mlp``, ``attention`` and
``spectral`` (the gated FFT long-convolution mixer)."""
