"""Models of the port: CLIP, Qwen2, Stable Diffusion and the tokenizers
(the re-exports of ``tvc/models/__init__.py``)."""

from tvc_torch.models.clip import (  # noqa: F401
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPConfig,
    CLIPModel,
    CLIPModule,
    normalize_pixels,
    preprocess_images,
)
from tvc_torch.models.qwen import QwenConfig, QwenModel  # noqa: F401
from tvc_torch.models.sd import SDConfig, StableDiffusionModel  # noqa: F401
from tvc_torch.models.tokenizer import BPETokenizer, HashTokenizer, get_tokenizer  # noqa: F401
