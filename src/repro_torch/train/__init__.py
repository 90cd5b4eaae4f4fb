"""Training: AdamW and its schedules (``optimizer``), the train step and
the loop (``train_loop``), checkpoints (``checkpoint``) and the
fault-tolerant loop (``fault_tolerance``), ported from ``repro/train``."""
