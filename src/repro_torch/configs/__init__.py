"""Model configurations (``configs.base``), the registry's ported entries and
the reduced-size shrink (``configs.reduce``)."""
