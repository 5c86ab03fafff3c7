"""Port parity: the host-side data path of training (data/synthetic.py,
data/converters.py, data/preprocess.py, data/feature_store.py,
data/dataset.py, data/collator.py) against revisionllm_tpu's originals.
These are NumPy copies, so everything must be equal exactly."""

import json
import os

import numpy as np
import pytest

from revisionllm_tpu.config import DataConfig as JD
from revisionllm_tpu.data import collator as jcol
from revisionllm_tpu.data import dataset as jds
from revisionllm_tpu.data import synthetic as jsyn
from revisionllm_tpu.utils.testing import FakeTokenizer as JF
from revisionllm_tpu_torch.config import DataConfig as TD
from revisionllm_tpu_torch.data import collator as tcol
from revisionllm_tpu_torch.data import dataset as tds
from revisionllm_tpu_torch.data import synthetic as tsyn
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TF

CORPUS = dict(n_train_movies=3, n_val_movies=1, d=16, duration=540.0, fps=1.0, seed=11)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    jp = jsyn.make_synthetic_corpus(str(root / "jax"), **CORPUS)
    tp = tsyn.make_synthetic_corpus(str(root / "port"), **CORPUS)
    return root, jp, tp


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_synthetic_corpus_writes_the_same_files(corpora):
    root, jp, tp = corpora
    assert {k: os.path.relpath(v, root / "jax") for k, v in jp.items() if k != "n_queries_val"} == \
        {k: os.path.relpath(v, root / "port") for k, v in tp.items() if k != "n_queries_val"}
    names = _files(root / "jax")
    assert names == _files(root / "port") and len(names) > 10
    for name in names:
        a, b = root / "jax" / name, root / "port" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(zb[k], za[k])
        else:
            assert json.loads(b.read_text()) == json.loads(a.read_text()), name


def _datasets(corpora, **overrides):
    root, jp, tp = corpora
    kw = {**dict(num_frames=16, debug_window=90, feature_fps=1.0, neg_window=True,
                 neg_samples=1.0, max_q_l=8, vis_feat_storage="npy"), **overrides}
    out = []
    for DC, DS, Tok, paths in ((JD, jds, JF, jp), (TD, tds, TF, tp)):
        cfg = DC(data_path=paths["train_json"], feat_folder=paths["features"],
                 q_feat_dir=paths["queries"], **kw)
        out.append(DS.GroundingDataset(paths["train_json"], Tok(), cfg,
                                       rng=np.random.default_rng(5), model_max_length=128))
    return out


def _assert_equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_items(a[k], b[k])
        elif isinstance(a[k], (np.ndarray, list, tuple)):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("overrides", [{}, {"neg_window": False, "neg_samples": 0.0}],
                         ids=["neg_windows", "positives"])
def test_dataset_items_match_jax(corpora, overrides):
    """The stage-1 item path: window crop, negative resampling, frame-token
    answers, tokenization and label masking, query features, from one rng."""
    jd, td = _datasets(corpora, **overrides)
    assert len(jd) == len(td) and len(jd) >= 12
    for i in list(range(len(jd))) + [3, 0, 7]:
        _assert_equal_items(jd[i], td[i])


def test_collator_batches_match_jax(corpora):
    jd, td = _datasets(corpora)
    jc = jcol.Collator(max_len=128, num_video_tokens=0, max_q_len=8)
    tc = tcol.Collator(max_len=128, num_video_tokens=0, max_q_len=8)
    for idx in ([0, 1], [5, 2], [11, 4]):
        jb = jc([jd[i] for i in idx])
        tb = tc([td[i] for i in idx])
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
        assert tb["images"].dtype == np.float32 and tb["text_ids"].dtype == np.int32
