"""Port parity: the data tools (data/converters.py, data/analysis.py,
data/debug_dataset.py) against revisionllm_tpu's on the same inputs: the
same records from every converter and from each CLI kind, byte-equal RVFS
stores from the .npy and .h5 conversions, the same statistics, checks and
id normalization, and the same items and shapes through the dataset and
collator."""

import json

import numpy as np
import pytest

from revisionllm_tpu.data import analysis as janalysis
from revisionllm_tpu.data import converters as jconv
from revisionllm_tpu.data import debug_dataset as jdebug
from revisionllm_tpu_torch.data import analysis as tanalysis
from revisionllm_tpu_torch.data import converters as tconv
from revisionllm_tpu_torch.data import debug_dataset as tdebug

MAD = {
    "q0": {"movie": "m1", "sentence": "Someone opens a door.", "timestamps": [3.14, 9.87],
           "movie_duration": 120.0},
    "q1": {"movie": "m2", "sentence": " A CAR drives ", "timestamps": [0.0, 4.05],
           "movie_duration": 60.5},
}
CHAPTERS = [
    {"vid": "v1", "duration": 300.0, "query": ["Intro", "The fight."],
     "relevant_windows": [[[0.0, 12.3]], [[100.0, 140.55]]]},
    {"vid": "v2", "duration": 50.0, "query": ["outro"], "relevant_windows": [[[40.0, 50.0]]]},
]
ANET = {"v_a": {"duration": 80.0, "timestamps": [[1.0, 5.0], [10.25, 30.0]],
                "sentences": ["A man runs.", "he stops"]}}
STAGE2 = [
    {"id": "s1", "meta": {"duration": 90.0, "token": {"<s0>": 1.0, "<e0>": 9.0, "<s1>": 20.0,
                                                      "<e1>": 33.0}},
     "conversations": [
         {"from": "human", "value": "<video>\nDuring which frames can we see a dog running "
                                    "happening in the video?"},
         {"from": "gpt", "value": "From <s1> to <e1>."},
         {"from": "human", "value": "Can you describe what occurred from <s0> to <e0> in the "
                                    "video?"},
         {"from": "gpt", "value": "A dog runs."},
         {"from": "human", "value": "Between which frames is the cat visible in the video?"},
         {"from": "gpt", "value": "from <s0> to <e0>"},
         {"from": "human", "value": "During which frames does the bird fly occur in the video?"},
         {"from": "gpt", "value": "From <s5> to <e5>."},
     ]},
]
MSRVTT = {"sentences": [
    {"video_id": "video1", "caption": "A man sings.", "sen_id": 0},
    {"video_id": "video2", "caption": "cars race", "sen_id": 1},
    {"video_id": "video1", "caption": "Someone plays guitar.", "sen_id": 2},
]}


def test_record_converters_match_jax(tmp_path):
    for neg in (False, True):
        assert tconv.mad_to_records(MAD, neg=neg) == jconv.mad_to_records(MAD, neg=neg)
        for ids in (None, ["video1"]):
            got = tconv.msrvtt_to_records(MSRVTT, ids, neg=neg)
            assert got == jconv.msrvtt_to_records(MSRVTT, ids, neg=neg) and got
    np.save(tmp_path / "v1.npy", np.zeros((3, 4), np.float32))
    for feat_dir in (None, str(tmp_path)):
        got = tconv.chapters_to_records(CHAPTERS, feat_dir)
        assert got == jconv.chapters_to_records(CHAPTERS, feat_dir)
    assert len(tconv.chapters_to_records(CHAPTERS, str(tmp_path))) == 2
    assert tconv.activitynet_to_records(ANET) == jconv.activitynet_to_records(ANET)
    got = tconv.stage2_to_records(STAGE2)
    assert got == jconv.stage2_to_records(STAGE2) and len(got) == 2
    assert got[0]["meta"]["token"] == {"<s0>": 20.0, "<e0>": 33.0}


def _store_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_store_converters_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    npy = tmp_path / "npy"
    npy.mkdir()
    for k in ("b", "a", "c"):
        np.save(npy / f"{k}.npy", rng.normal(size=(5, 8)).astype(np.float32))
    assert tconv.npy_dir_to_rvfs(str(npy), str(tmp_path / "t.rvfs")) == 3
    jconv.npy_dir_to_rvfs(str(npy), str(tmp_path / "j.rvfs"))
    assert _store_bytes(tmp_path / "t.rvfs") == _store_bytes(tmp_path / "j.rvfs")

    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "f.h5", "w") as f:
        f["movie1"] = rng.normal(size=(6, 4)).astype(np.float64)
        g = f.create_group("q1")
        g["token_features"] = rng.normal(size=(3, 4))
        g["cls_features"] = rng.normal(size=(4,))
    for key in (None, "q1"):
        n = tconv.h5_to_rvfs(str(tmp_path / "f.h5"), str(tmp_path / "t.rvfs"), key)
        jconv.h5_to_rvfs(str(tmp_path / "f.h5"), str(tmp_path / "j.rvfs"), key)
        assert n == (2 if key is None else 1)
        assert _store_bytes(tmp_path / "t.rvfs") == _store_bytes(tmp_path / "j.rvfs")


@pytest.mark.parametrize("kind,data,ext", [
    ("mad", MAD, ".json"), ("chapters", CHAPTERS, ".jsonl"), ("activitynet", {"videos": ANET},
                                                               ".json"),
    ("stage2", STAGE2, ".json"), ("msrvtt", MSRVTT, ".json")])
def test_converter_cli_matches_jax(tmp_path, capsys, kind, data, ext):
    src = tmp_path / f"in{ext}"
    with open(src, "w") as f:
        if ext == ".jsonl":
            f.write("\n".join(json.dumps(x) for x in data))
        else:
            json.dump(data, f)
    for pkg, mod in (("port", tconv), ("jax", jconv)):
        mod.main([kind, "--in_path", str(src), "--out_path", str(tmp_path / f"{pkg}.json"),
                  "--neg"])
    port, jax_ = capsys.readouterr().out.splitlines()
    assert port == jax_.replace("jax.json", "port.json") and port.startswith("wrote ")
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("kind", ["npy2rvfs", "h52rvfs"])
def test_store_converter_cli_matches_jax(tmp_path, capsys, kind):
    rng = np.random.default_rng(1)
    if kind == "npy2rvfs":
        src = tmp_path / "npy"
        src.mkdir()
        for k in ("m1", "m0"):
            np.save(src / f"{k}.npy", rng.normal(size=(4, 6)).astype(np.float32))
    else:
        h5py = pytest.importorskip("h5py")
        src = tmp_path / "f.h5"
        with h5py.File(src, "w") as f:
            f["m0"] = rng.normal(size=(4, 6))
    for pkg, mod in (("port", tconv), ("jax", jconv)):
        mod.main([kind, "--in_path", str(src), "--out_path", str(tmp_path / f"{pkg}.rvfs")])
    port, jax_ = capsys.readouterr().out.splitlines()
    assert port == jax_.replace("jax.rvfs", "port.rvfs") and port.startswith("wrote ")
    assert _store_bytes(tmp_path / "port.rvfs") == _store_bytes(tmp_path / "jax.rvfs")


def _records():
    return [
        {"query_id": "a", "id": "dir/movie1.mp4", "meta": {"duration": 30.0,
                                                           "token": {"<s0>": 2.0, "<e0>": 7.5}}},
        {"query_id": "b", "id": "movie2.npy", "meta": {"duration": 90.0}},
        {"query_id": "c", "id": "movie3", "meta": {"duration": 45.0,
                                                   "token": {"<s0>": 0.0, "<e0>": 40.0}}},
        {"query_id": "d", "id": "movie1"},
    ]


def test_analysis_matches_jax(tmp_path, capsys):
    recs = _records()
    assert tanalysis.stats(recs) == janalysis.stats(recs)
    assert tanalysis.reformat_ids([dict(r) for r in recs]) == \
        janalysis.reformat_ids([dict(r) for r in recs])
    feats = tmp_path / "feats"
    feats.mkdir()
    np.save(feats / "movie1.npy", np.zeros((10, 4), np.float32))
    np.save(feats / "movie2.npy", np.zeros((3, 4), np.float32))
    fixed = tanalysis.reformat_ids([dict(r) for r in recs])
    for n in (0, 5):
        got = tanalysis.check(fixed, str(feats), n)
        assert got == janalysis.check(fixed, str(feats), n)
    assert got == {"missing": ["movie3"], "too_short": ["movie2"], "checked": 3}

    data = tmp_path / "recs.json"
    with open(data, "w") as f:
        json.dump({r["query_id"]: r for r in recs}, f)   # the dict form, keyed by query id
    assert tanalysis.load_records(str(data)) == janalysis.load_records(str(data))
    for argv in (["stats"], ["check", "--feat_folder", str(feats), "--num_frames", "5"]):
        for mod in (tanalysis, janalysis):
            mod.main(argv + ["--data_path", str(data)])
        port, jax_ = capsys.readouterr().out.split("\n}\n")[:2]
        assert json.loads(port + "}") == json.loads(jax_ + "}")
    for pkg, mod in (("port", tanalysis), ("jax", janalysis)):
        mod.main(["reformat", "--data_path", str(data), "--out_path", str(tmp_path / pkg)])
    with open(tmp_path / "port") as f, open(tmp_path / "jax") as g:
        assert json.load(f) == json.load(g)


def test_debug_dataset_matches_jax(tmp_path, capsys):
    """debug() over each package's dataset and collator on the synthetic
    corpus: the same item count and image shapes; main runs."""
    from revisionllm_tpu.config import DataConfig as JD
    from revisionllm_tpu.config import get_preset as jpreset
    from revisionllm_tpu.data.collator import Collator as JC
    from revisionllm_tpu.data.dataset import GroundingDataset as JG
    from revisionllm_tpu.data.synthetic import make_synthetic_corpus
    from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
    from revisionllm_tpu_torch.config import DataConfig as TD
    from revisionllm_tpu_torch.config import get_preset as tpreset
    from revisionllm_tpu_torch.data.collator import Collator as TC
    from revisionllm_tpu_torch.data.dataset import GroundingDataset as TG
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

    c = make_synthetic_corpus(str(tmp_path / "c"), n_train_movies=2, n_val_movies=1,
                              duration=270.0, seed=3)
    out = []
    for D, preset, G, C, Tok, mod in ((JD, jpreset, JG, JC, JTok, jdebug),
                                      (TD, tpreset, TG, TC, TTok, tdebug)):
        cfg = D(**{**preset("synthetic_tiny").data.__dict__, "data_path": c["train_json"],
                   "feat_folder": c["features"]})
        ds = G(c["train_json"], Tok(), cfg, rng=np.random.default_rng(0))
        out.append(mod.debug(ds, C(max_len=2048, num_video_tokens=0), batch_size=3, limit=7))
    want, got = out
    assert got["items"] == want["items"] == 7
    assert got["image_shapes"] == want["image_shapes"] == [(16, 16)]
    assert got["items_per_sec"] > 0
    tdebug.main(["--data_path", c["train_json"], "--feat_folder", c["features"], "--preset",
                 "synthetic_tiny", "--limit", "4"])
    assert "'items': 4" in capsys.readouterr().err
