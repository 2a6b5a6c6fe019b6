"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, per-layer metric or kernel count
is a file of its own under ``bench/``, found by the name that
``BENCHMARK.json`` gives it (``spec.py``). This package is the fixed part:
the closed-loop traffic (``traffic.py``), the weights drawn from the seed
(``weights.py``), the measured window (``window.py``), the device trace
(``trace.py``), the comparison with the plain reference that decides
``correct`` (``check.py``) and the run as a whole (``cell.py``).
"""
