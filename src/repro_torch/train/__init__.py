"""Training: AdamW and its schedules (``optimizer``), the train step and
the loop (``train_loop``), ported from ``repro/train``."""
