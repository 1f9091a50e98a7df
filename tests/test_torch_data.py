"""Data plane of the PyTorch port's training path (peneo_tpu_torch/data,
pipeline/loader.py) against the JAX package's on one synthetic RFUND
corpus: the corpus writers write identical files; ``RFUNDDataset`` items,
``PEneoCollator`` batches (spot labels and dense int8 labels) and
``DataFeed`` batch order are byte-equal, including box augmentation under
one seed; ``set_state`` resumes on the same batches as an uninterrupted
run; SIBR items agree too; the device copy keeps the arrays."""

import random

import numpy as np
import pytest
import torch

from peneo_tpu.data import synthetic as jsyn
from peneo_tpu.data.collator import PEneoCollator as JaxCollator
from peneo_tpu.data.datasets import RFUNDDataset as JaxRFUND
from peneo_tpu.data.datasets import SIBRDataset as JaxSIBR
from peneo_tpu.data.fetchers import fetch_xlm as jax_fetch
from peneo_tpu.pipeline.loader import DataFeed as JaxFeed
from peneo_tpu_torch.data import synthetic as tsyn
from peneo_tpu_torch.data.collator import PEneoCollator
from peneo_tpu_torch.data.datasets import RFUNDDataset, SIBRDataset
from peneo_tpu_torch.data.fetchers import fetch_xlm
from peneo_tpu_torch.pipeline.loader import DataFeed, batch_arrays, \
    batch_to_device

torch.set_num_threads(1)
L = 128


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("rfund")
    jroot = tmp_path_factory.mktemp("rfund_jax")
    tsyn.write_rfund_dataset(str(root), "en", n_train=12, n_val=4)
    jsyn.write_rfund_dataset(str(jroot), "en", n_train=12, n_val=4)
    for name in ("en.train.json", "en.val.json"):
        assert (root / name).read_bytes() == (jroot / name).read_bytes()
    return str(root)


def _datasets(root, aug=False):
    kw = dict(max_token_len=L - 1, add_cls_token=True, apply_box_aug=aug)
    ours = RFUNDDataset(root, "train", "en", tokenizer=tsyn.ToyTokenizer(),
                        tokenizer_fetcher=fetch_xlm, **kw)
    theirs = JaxRFUND(root, "train", "en", tokenizer=jsyn.ToyTokenizer(),
                      tokenizer_fetcher=jax_fetch, **kw)
    return ours, theirs


def _assert_batches_equal(a, b):
    for key in ("input_ids", "bbox", "orig_bbox", "attention_mask",
                "seq_len"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key
    assert set(a.labels) == set(b.labels)
    for name in a.labels:
        assert a.labels[name].dtype == b.labels[name].dtype, name
        assert a.labels[name].tobytes() == b.labels[name].tobytes(), name
    assert a.texts == b.texts and a.fnames == b.fnames
    assert a.relations == b.relations


@pytest.mark.parametrize("spots", [True, False])
def test_items_and_batches_byte_equal(corpus, spots):
    ours, theirs = _datasets(corpus)
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        assert ours[i] == theirs[i]
    kw = dict(max_seq_len=L, pad_token_id=0, labels_as_spots=spots)
    feats = [ours[i] for i in range(4)]
    _assert_batches_equal(PEneoCollator(**kw)(feats),
                          JaxCollator(**kw)(feats))


def test_box_augmentation_byte_equal_under_one_seed(corpus):
    ours, theirs = _datasets(corpus, aug=True)
    assert not ours.deterministic
    random.seed(5)
    a = [ours[i] for i in range(6)]
    random.seed(5)
    b = [theirs[i] for i in range(6)]
    assert a == b
    plain, _ = _datasets(corpus)
    assert any(x["bbox"] != plain[i]["bbox"] for i, x in enumerate(a))


def test_feed_order_and_resume(corpus):
    ours, theirs = _datasets(corpus)
    coll = PEneoCollator(max_seq_len=L, labels_as_spots=True)
    jcoll = JaxCollator(max_seq_len=L, labels_as_spots=True)
    feed = DataFeed(ours, coll, batch_size=3, seed=7, num_workers=2)
    jfeed = JaxFeed(theirs, jcoll, batch_size=3, seed=7, num_workers=2)
    run = [b for _ in range(2) for b in feed]  # two epochs
    jrun = [b for _ in range(2) for b in jfeed]
    assert len(run) == 8
    for a, b in zip(run, jrun):
        _assert_batches_equal(a, b)
    assert run[0].fnames != run[4].fnames  # reshuffled per epoch
    # resume at epoch 1 after 2 batches: the next batches are run[6:]
    resumed = DataFeed(ours, coll, batch_size=3, seed=7, num_workers=2)
    resumed.set_state(1, 2)
    for a, b in zip(list(resumed), run[6:]):
        _assert_batches_equal(a, b)


def test_sibr_items_equal(tmp_path):
    tsyn.write_sibr_dataset(str(tmp_path), n_train=3, n_test=2)
    kw = dict(max_token_len=L - 1, add_cls_token=True)
    ours = SIBRDataset(str(tmp_path), "train", tokenizer=tsyn.ToyTokenizer(),
                       tokenizer_fetcher=fetch_xlm, **kw)
    theirs = JaxSIBR(str(tmp_path), "train", tokenizer=jsyn.ToyTokenizer(),
                     tokenizer_fetcher=jax_fetch, **kw)
    assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)]


def test_batch_to_device_keeps_arrays(corpus):
    ours, _ = _datasets(corpus)
    batch = PEneoCollator(max_seq_len=L, labels_as_spots=True)(
        [ours[i] for i in range(2)])
    dev = batch_to_device(batch, "cpu")
    host = batch_arrays(batch)
    for key in ("input_ids", "bbox", "attention_mask"):
        np.testing.assert_array_equal(dev[key].numpy(), host[key])
    for name in host["labels"]:
        np.testing.assert_array_equal(dev["labels"][name].numpy(),
                                      host["labels"][name])


def test_layoutlmv3_batches_byte_equal_with_images(tmp_path):
    """A corpus written ``with_images``, datasets with CLS and SEP, and
    collators with each package's LayoutLMv3 image loader: the PNG files and the batches, ``image``
    included, are byte-equal; ``batch_arrays`` and ``model_inputs`` carry
    the image."""
    from peneo_tpu.config import LayoutLMv3Config, PEneoConfig
    from peneo_tpu.data.image_processing import make_image_loader as jax_loader
    from peneo_tpu_torch.config import PEneoConfig as PortConfig
    from peneo_tpu_torch.data.image_processing import make_image_loader

    root, jroot = tmp_path / "port", tmp_path / "jax"
    kw = dict(n_train=4, n_val=2, with_images=True)
    tsyn.write_rfund_dataset(str(root), "en", **kw)
    jsyn.write_rfund_dataset(str(jroot), "en", **kw)
    pngs = sorted(p.name for p in (root / "images" / "en").iterdir())
    assert len(pngs) == 6
    for name in pngs:
        assert (root / "images" / "en" / name).read_bytes() == \
            (jroot / "images" / "en" / name).read_bytes()
    cfg = PEneoConfig(backbone_name="layoutlmv3-base-chinese",
                      backbone_config=LayoutLMv3Config(
                          input_size=32).to_dict())
    ds_kw = dict(max_token_len=L - 2, add_cls_token=True, add_sep_token=True)
    ours = RFUNDDataset(str(root), "train", "en",
                        tokenizer=tsyn.ToyTokenizer(),
                        tokenizer_fetcher=fetch_xlm, **ds_kw)
    theirs = JaxRFUND(str(root), "train", "en", tokenizer=jsyn.ToyTokenizer(),
                      tokenizer_fetcher=jax_fetch, **ds_kw)
    feats = [ours[i] for i in range(4)]
    assert feats == [theirs[i] for i in range(4)]
    a = PEneoCollator(max_seq_len=L, labels_as_spots=True,
                      image_loader=make_image_loader(
                          PortConfig.from_dict(cfg.to_dict())))(feats)
    b = JaxCollator(max_seq_len=L, labels_as_spots=True,
                    image_loader=jax_loader(cfg))(feats)
    _assert_batches_equal(a, b)
    assert a.image.dtype == b.image.dtype == np.float32
    assert a.image.shape == (4, 3, 32, 32)
    assert a.image.tobytes() == b.image.tobytes()
    assert a.image.std() > 0
    assert batch_arrays(a)["image"] is a.image
    assert a.model_inputs()["image"] is a.image
    dev = batch_to_device(a, "cpu")
    np.testing.assert_array_equal(dev["image"].numpy(), a.image)
    # SEP sits inside the taggable range: seq_len counts it
    sep = tsyn.ToyTokenizer().sep_token_id
    for i in range(4):
        assert a.input_ids[i, a.seq_len[i]] == sep


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA", "LA", "1"])
@pytest.mark.parametrize("shape", [(1400, 1000), (37, 53)])
def test_page_image_loaders_equal_jax(tmp_path, mode, shape):
    """The port's page-image loaders (one read, one decode, a grayscale page
    resized before it is made RGB) give the JAX package's pixels bit for
    bit, uint8 and float32, for every mode a PNG page may have, large pages
    (written in many IDAT chunks) and small, at 224 px and at 32."""
    from PIL import Image

    from peneo_tpu.data import image_processing as jax_ip
    from peneo_tpu_torch.data import image_processing as ip

    rng = np.random.default_rng(sum(shape) + len(mode))
    levels = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
    levels[shape[0] // 3:, shape[1] // 2:] //= 8  # a dark block: ink
    im = Image.fromarray(levels, "RGBA")
    im = im.convert(mode) if mode != "P" else im.convert("RGB").quantize(64)
    path = str(tmp_path / "page.png")
    im.save(path)
    for size in (224, 32):
        want = jax_ip.load_rgb_u8(path, size)
        got = ip.load_rgb_u8(path, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        assert got.tobytes() == want.tobytes()
        assert ip.load_rgb(path, size).tobytes() == \
            jax_ip.load_rgb(path, size).tobytes()
