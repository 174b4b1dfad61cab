"""The plain reference of the benchmark: finite elements written from the
equations in PyTorch (`fem.py`), the comparisons that decide `correct`
(`checks.py`) and the float32 control (`control.py`).  It imports nothing
of the program (`feddlib_tpu_torch`), of the JAX package or of JAX."""
