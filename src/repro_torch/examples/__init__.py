"""The port's end-to-end examples (counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name>``, on ``cuda`` by
default and on the CPU with ``--device cpu``.  Each asserts the same
agreements as the reference's example and prints the same lines."""
