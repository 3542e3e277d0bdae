"""Text augmentation (port of ``tvc/augment``)."""

from tvc_torch.augment.text_augment import (  # noqa: F401
    BackTranslator,
    ParaphraseGenerator,
    SynonymReplacer,
    SyntaxTransformer,
    TemplateAugmenter,
    TextAugmentConfig,
    TextAugmenter,
    create_text_augmenter,
    is_valid_text,
    normalize_text,
)
