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

from tvc_torch import core  # noqa: F401

# Lazy top-level API, the JAX package's names (tvc/__init__.py)
_LAZY = {
    "CLIPModel": "tvc_torch.models",
    "CLIPConfig": "tvc_torch.models",
    "QwenModel": "tvc_torch.models",
    "QwenConfig": "tvc_torch.models",
    "StableDiffusionModel": "tvc_torch.models",
    "SDConfig": "tvc_torch.models",
    "TextAugmenter": "tvc_torch.augment",
    "TextAugmentConfig": "tvc_torch.augment",
    "MultiModalRetriever": "tvc_torch.retrieval",
    "RetrievalConfig": "tvc_torch.retrieval",
    "AdversarialDetector": "tvc_torch.detector",
    "DetectorConfig": "tvc_torch.detector",
    "EnsembleDetector": "tvc_torch.detector",
    "MultiModalDetectionPipeline": "tvc_torch.pipeline",
    "DefensePipeline": "tvc_torch.pipeline",
    "PipelineConfig": "tvc_torch.pipeline",
    "SDReferenceGenerator": "tvc_torch.sd_ref",
    "EmbeddingBank": "tvc_torch.bank",
    "ReferenceBank": "tvc_torch.bank",
    "ServingRuntime": "tvc_torch.serving",
    "ServingConfig": "tvc_torch.serving",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'tvc_torch' has no attribute {name!r}")
