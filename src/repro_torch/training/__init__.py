"""Training of the port: the loss and step functions (``steps.py``) and the
teacher -> trajectories -> student training loops (``trainer.py``)."""
