"""Data: ``pipeline`` (the deterministic synthetic LM batches) and the
package data ``tuning_seed.json``, the tuner's read-only seed of winners
measured on the card (:func:`repro_torch.core.tuning.seed_cache`)."""
