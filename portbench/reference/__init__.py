"""Plain PyTorch references of the benchmark's configurations.

Float32 with TF32 off, written from the published model descriptions and
the configuration files under ``portbench/configs``. Nothing here imports
the program under test: the weights come in as a dict of tensors keyed by
their state-dict names, and every derived quantity (scene boundaries,
pooled tokens, the splice, the cache) is worked out again here.

``Precision`` selects how each dense product is computed: ``"f32"`` is the
reference proper; ``"fp8"`` rounds both operands of every dense product to
float8 e4m3 (per-row activation and per-output-channel weight scales), the
control that the comparison has to fail.
"""
