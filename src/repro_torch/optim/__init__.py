"""AdamW of the port (``optim/adamw.py``)."""
