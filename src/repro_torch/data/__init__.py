"""Package data: ``tuning_seed.json``, the tuner's read-only seed of
winners measured on the card (:func:`repro_torch.core.tuning.seed_cache`)."""
