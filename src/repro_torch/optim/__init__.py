"""AdamW with fp32 masters over the param tree (``adamw``)."""
