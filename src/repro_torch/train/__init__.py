"""Training: the train step (``step``), checkpoints (``checkpoint``) and the
fault-tolerant loop (``loop``)."""
