"""Synthetic data generators that need no dataset (numpy, seeded): copies
of the reference's ``data/images.py`` and ``data/vibration.py``."""
