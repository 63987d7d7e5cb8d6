"""Serving steps and atomic checkpoints (counterpart of ``repro.train``;
training is not ported yet, ROADMAP.md queue 1, item 10)."""
