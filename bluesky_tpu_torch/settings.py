"""The settings the slice reads (a copy of two ``bluesky_tpu.settings``
values; the port imports nothing from the JAX package).

``perf_path`` is relative to the working directory: the port reads no
data outside its checkout, so without a ``data/performance`` directory
``Traffic`` uses the built-in coefficient tables.
"""
import os

performance_model = "openap"
data_path = "data"
perf_path = os.path.join(data_path, "performance")
