"""The JAX package's example scripts (``examples/*.py``) as the port's
entry points: ``python -m fftisdf_tpu_torch.examples.<name>``, on the card
by default (``--device cpu`` on the host)."""
