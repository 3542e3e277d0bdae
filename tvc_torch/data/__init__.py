"""Dataset loaders (port of ``tvc/data``)."""

from tvc_torch.data.loaders import (  # noqa: F401
    DATASETS,
    BaseDataset,
    CC3MDataset,
    COCODataset,
    DataConfig,
    DataLoaderManager,
    Flickr30kDataset,
    Sample,
    SyntheticDataset,
    VisualGenomeDataset,
    loader_to_list,
    render_synthetic_image,
)
