"""Training (port of `repro.train`): AdamW, int8 gradient compression, the
train step and the fault-tolerant `Trainer`."""
