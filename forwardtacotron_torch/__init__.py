"""ForwardTacotron on PyTorch and CUDA: the port of ``forwardtacotron_tpu``
to an NVIDIA H100.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package that
the ported paths run is a hand-written Hopper kernel under ``ops/hopper``
with a plain-PyTorch twin beside it. Module paths mirror the JAX package so
each counterpart is found at the same place. Entry points run on the GPU
unless the caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"
