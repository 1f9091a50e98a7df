"""The evaluation half of the PyTorch port's training path
(pipeline/evaluation.py: ``match_counts``, ``calculate_kvpe_metric``,
``calculate_detail_kvpe_metric``; pipeline/decode.py:
``spots_from_label_matrices``, ``decode_batch``) against the JAX package's
on one synthetic RFUND batch of 6 pages. The predictions are the ground
truth itself on the even pages and a perturbed copy of it on the odd ones
(a quarter of the links dropped, a few random ones added), and the file
names repeat, so the metrics count true positives, misses, false positives
and the file-name dedup. Both packages must decode the same records from
the same inputs and give the same metrics, exactly."""

import numpy as np
import pytest

from peneo_tpu.pipeline import decode as jdec
from peneo_tpu.pipeline import evaluation as jev
from peneo_tpu_torch.data import synthetic as tsyn
from peneo_tpu_torch.data.collator import PEneoCollator
from peneo_tpu_torch.data.datasets import RFUNDDataset
from peneo_tpu_torch.data.fetchers import fetch_xlm
from peneo_tpu_torch.pipeline import decode as dec
from peneo_tpu_torch.pipeline import evaluation as ev

L = 128
N_PAGES = 6


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """The same 6 pages collated with dense int8 labels and with spot
    labels."""
    root = str(tmp_path_factory.mktemp("rfund"))
    tsyn.write_rfund_dataset(root, "en", n_train=N_PAGES, n_val=2)
    ds = RFUNDDataset(root, "train", "en", tokenizer=tsyn.ToyTokenizer(),
                      tokenizer_fetcher=fetch_xlm, max_token_len=L - 1,
                      add_cls_token=True)
    feats = [ds[i] for i in range(N_PAGES)]
    return {spots: PEneoCollator(max_seq_len=L, labels_as_spots=spots)(feats)
            for spots in (False, True)}


def _predictions(dense_labels, seed):
    """Dense tag and score maps per head: the ground truth on even pages;
    on odd pages a quarter of its links dropped and 4 random links added."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, m in dense_labels.items():
        tags = np.asarray(m, dtype=np.int64).copy()
        n_tags = 2 if name == "line_extraction" else 3
        for b in range(1, tags.shape[0], 2):
            i, j = np.nonzero(tags[b])
            drop = rng.random(len(i)) < 0.25
            tags[b, i[drop], j[drop]] = 0
            for _ in range(4):
                r = int(rng.integers(0, tags.shape[1]))
                c = int(rng.integers(r, tags.shape[2]))
                tags[b, r, c] = int(rng.integers(1, n_tags))
        scores = rng.uniform(0.5, 1.0, size=tags.shape).astype(np.float32)
        out[name] = {"tags": tags, "scores": scores}
    return out


@pytest.mark.parametrize("spot_labels", [False, True])
def test_decode_batch_and_kvpe_metrics_match_jax(batches, spot_labels):
    batch = batches[spot_labels]
    preds = _predictions(batches[False].labels, seed=11)
    seq_lens = [int(s) for s in batch.seq_len]
    fnames = [f"doc{i % 4}.png" for i in range(N_PAGES)]  # 2 repeats

    ours = dec.decode_batch(batch.texts, preds, batch.labels, seq_lens,
                            fnames)
    theirs = jdec.decode_batch(batch.texts, preds, batch.labels, seq_lens,
                               fnames)
    assert ours == theirs
    all_pred, all_gt, all_fname = ours
    # the ground truth decodes the same from dense and from spot labels
    assert all_gt == dec.decode_batch(
        batch.texts, preds, batches[not spot_labels].labels, seq_lens,
        fnames)[1]

    summary, detail = ev.calculate_kvpe_metric(all_pred, all_gt, all_fname)
    assert (summary, detail) == jev.calculate_kvpe_metric(
        all_pred, all_gt, all_fname)
    # a test with matches: some kv pairs found, some missed
    assert 0 < detail["num_correct"] < detail["num_gt"]
    assert detail["num_sample_processed"] == 4

    summary, detail = ev.calculate_detail_kvpe_metric(all_pred, all_gt,
                                                      all_fname)
    assert (summary, detail) == jev.calculate_detail_kvpe_metric(
        all_pred, all_gt, all_fname)
    for task in ev.TASKS:
        assert detail[task]["num_correct"] > 0, task
        assert detail[task]["num_correct"] < detail[task]["num_pred"] \
            or detail[task]["num_correct"] < detail[task]["num_gt"], task


def test_match_counts_match_jax():
    pred = [("a", "1"), ("b", "2"), ("c", "3"), ("a", "1")]
    gt = [("a", "1"), ("c", "3"), ("d", "4")]
    ours, theirs = [], []
    assert ev.match_counts(pred, gt, ours) == jev.match_counts(pred, gt,
                                                               theirs)
    assert ours == theirs
    assert ev.match_counts(pred, gt) == (4.0, 3.0, 3.0)
