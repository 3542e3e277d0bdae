"""tvc_torch.data.loaders against tvc.data.loaders: rendered pixels and
caption order bit-equal, the on-disk datasets over directories written to
``tmp_path`` (nothing is downloaded), batching and prefetch."""

import gzip
import json

import numpy as np
import pytest
from PIL import Image

import tvc.data.loaders as jl
import tvc_torch.data.loaders as tl


def test_caption_asset_is_read_in_place():
    assert tl._CAPTION_ASSET == jl._CAPTION_ASSET and tl._CAPTION_ASSET.exists()


@pytest.mark.parametrize("all_captions", [False, True])
def test_coco_caption_order_equals_jax(all_captions):
    want = jl.load_coco_captions(all_captions=all_captions)
    got = tl.load_coco_captions(all_captions=all_captions)
    assert got == want and len(got) > 4000


@pytest.mark.parametrize("caption,size,seed", [
    ("a man riding a wave on top of a surfboard.", 32, 7), ("the of a", 16, None), ("Ünïcode café", 24, 3),
])
def test_render_caption_image_bit_equal(caption, size, seed):
    np.testing.assert_array_equal(tl.caption_render_vector(caption), jl.caption_render_vector(caption))
    got = tl.render_caption_image(caption, size, noise_seed=seed)
    want = jl.render_caption_image(caption, size, noise_seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tl._fnv1a(caption) == jl._fnv1a(caption)


@pytest.mark.parametrize("combo,seed", [((0, 0, 0), None), ((5, 7, 5), 11), ((2, 3, 4), 0)])
def test_render_synthetic_image_bit_equal(combo, seed):
    np.testing.assert_array_equal(tl.render_synthetic_image(combo, 24, noise_seed=seed),
                                  jl.render_synthetic_image(combo, 24, noise_seed=seed))


@pytest.mark.parametrize("name,kw", [("synthetic", dict(max_samples=20, seed=3)),
                                     ("coco_captions", dict(max_samples=12))])
def test_datasets_and_batches_equal_jax(name, kw):
    cfg = dict(image_size=16, batch_size=5, **kw)
    td = tl.DataLoaderManager(tl.DataConfig(**cfg)).load_dataset(name)
    jd = jl.DataLoaderManager(jl.DataConfig(**cfg)).load_dataset(name)
    assert len(td) == len(jd)
    for shuffle in (False, True):
        tb, jb = list(td.batches(shuffle=shuffle)), list(jd.batches(shuffle=shuffle))
        assert len(tb) == len(jb) == -(-len(jd) // 5)
        for a, b in zip(tb, jb):
            assert a["texts"] == b["texts"] and a["ids"] == b["ids"]
            np.testing.assert_array_equal(a["images"], b["images"])
    pre = list(td.prefetch_batches(batch_size=7))
    assert [b["texts"] for b in pre] == [b["texts"] for b in jd.batches(batch_size=7)]
    got, want = tl.loader_to_list(td, max_samples=9), jl.loader_to_list(jd, max_samples=9)
    assert len(got) == 9 and [t for _, t, _ in got] == [t for _, t, _ in want]
    assert not any(flag for _, _, flag in got)
    np.testing.assert_array_equal(np.stack([i for i, _, _ in got]), np.stack([i for i, _, _ in want]))


def test_coco_captions_skip_and_drop_remainder():
    cfg = dict(image_size=8, max_samples=7, drop_remainder=True)
    td = tl.COCOCaptionsDataset(tl.DataConfig(**cfg), skip=5)
    jd = jl.COCOCaptionsDataset(jl.DataConfig(**cfg), skip=5)
    assert [s.caption for s in td.samples] == [s.caption for s in jd.samples]
    assert [len(b["texts"]) for b in td.batches(batch_size=3)] == [3, 3]


def _image(path, color):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.new("RGB", (10, 6), color).save(path)


@pytest.fixture
def disk(tmp_path):
    """Tiny COCO / Flickr30k / CC3M / Visual Genome trees."""
    root = tmp_path
    ann = {
        "images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"}],
        "annotations": [{"image_id": 1, "caption": " a cat "}, {"image_id": 1, "caption": "dup"},
                        {"image_id": 2, "caption": "a dog"}],
    }
    (root / "coco" / "annotations").mkdir(parents=True)
    (root / "coco" / "annotations" / "captions_val2017.json").write_text(json.dumps(ann))
    _image(root / "coco" / "val2017" / "a.jpg", (255, 0, 0))
    _image(root / "coco" / "val2017" / "b.jpg", (0, 0, 255))
    (root / "flickr30k").mkdir()
    (root / "flickr30k" / "results_20130124.token").write_text(
        "x.jpg#0\ta boat\nx.jpg#1\tsame image\nbad line\ny.jpg#0\t a tree \n")
    _image(root / "flickr30k" / "images" / "x.jpg", (0, 255, 0))
    _image(root / "flickr30k" / "images" / "y.jpg", (9, 9, 9))
    (root / "cc3m").mkdir()
    (root / "cc3m" / "val.tsv").write_text("a kite\thttp://h/p/k.jpg\nshort\n a bus \tb.jpg\n")
    _image(root / "cc3m" / "images" / "k.jpg", (1, 2, 3))
    _image(root / "cc3m" / "images" / "b.jpg", (4, 5, 6))
    (root / "visual_genome").mkdir()
    (root / "visual_genome" / "region_descriptions.json").write_text(json.dumps([
        {"id": 7, "regions": [{"phrase": " a red sign "}]}, {"id": 8, "regions": []},
        {"image_id": 9, "regions": [{"phrase": ""}]}, {"image_id": 10, "regions": [{"phrase": "grass"}]},
    ]))
    _image(root / "visual_genome" / "images" / "7.jpg", (200, 100, 0))
    _image(root / "visual_genome" / "images" / "10.jpg", (0, 100, 200))
    return root


@pytest.mark.parametrize("name", ["coco", "flickr30k", "cc3m", "visual_genome"])
def test_on_disk_datasets_equal_jax(disk, name):
    cfg = dict(data_dir=str(disk), image_size=8, split="val")
    td = tl.DATASETS[name](tl.DataConfig(**cfg))
    jd = jl.DATASETS[name](jl.DataConfig(**cfg))
    assert len(td) == len(jd) == 2
    assert [(s.caption, s.image_id, s.image_path) for s in td.samples] == \
        [(s.caption, s.image_id, s.image_path) for s in jd.samples]
    (tb,), (jb,) = list(td.batches()), list(jd.batches())
    assert tb["images"].shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(tb["images"], jb["images"])
    one = tl.DATASETS[name](tl.DataConfig(max_samples=1, **cfg))
    assert len(one) == 1


def test_coco_captions_prefer_the_local_annotations(disk):
    got = tl.load_coco_captions(str(disk))
    assert got == jl.load_coco_captions(str(disk)) and sorted(got) == [(1, "a cat"), (2, "a dog")]
    assert len(tl.load_coco_captions(str(disk), all_captions=True)) == 3
    with pytest.raises(FileNotFoundError):
        tl.load_coco_captions(str(disk), split="train")


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        tl.DataLoaderManager().load_dataset("imagenet")
    assert set(tl.DATASETS) == set(jl.DATASETS)


def test_bundled_asset_is_the_gzip_json_the_jax_package_reads():
    with gzip.open(tl._CAPTION_ASSET, "rt") as f:
        pairs = json.load(f)
    assert len(pairs) == len(jl.load_coco_captions(all_captions=True))
