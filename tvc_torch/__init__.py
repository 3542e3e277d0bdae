"""tvc_torch — the PyTorch/CUDA port of ``tvc`` for NVIDIA Hopper (H100).

The JAX package ``tvc`` is the reference; each module here keeps the
relative path and public names of the ``tvc`` module it ports. The hot-path
TPU kernels are hand-written CUDA C++ (``tvc_torch/csrc``), built at first
use by ``tvc_torch.core.kernels._build``.

Entry points (``CLIPModel``, ``EmbeddingBank``, ``make_serving_step``,
``AdversarialDetector``, ``ServingRuntime``) run on the card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
