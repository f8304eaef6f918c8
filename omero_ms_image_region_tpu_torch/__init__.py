"""PyTorch/CUDA port of omero-ms-image-region.

The same request surface as the JAX package ``omero_ms_image_region_tpu``
(which stays the reference), rendered on an NVIDIA H100 through
hand-written CUDA kernels (``kernels/``).  Nothing here imports JAX or the
JAX package.

Entry points take an explicit ``device`` and default to ``"cuda"``; they
run on the CPU only when the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
