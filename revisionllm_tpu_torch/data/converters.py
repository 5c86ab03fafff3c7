"""Dataset converters: raw annotation files -> unified grounding records.

Behavioral parity with the reference converter scripts, all emitting the
"activitynet-style" record the dataset consumes:
  {query_id, id, conversations: [human '<video>\n During which frames...',
   gpt 'From <s0> to <e0>.'], meta: {duration, token: {<s0>, <e0>}}, source}

- MAD:        reference revisionllm/data/mad/mad_to_activitynet.py:43-76
- VidChapters reference revisionllm/data/vidchap7m/chapters_to_activitynet.py:47-84
- ActivityNet reference revisionllm/data/activitynet_to_activitynet.py
- stage2 mining: grounding pairs extracted from VTimeLLM stage-2 dialogue data
  via the caption-template regexes
  (reference revisionllm/data/stage2_to_activitynet.py:70-139)
- store conversion: .npy/.h5 feature dirs -> RVFS (replacing
  convert_npy_to_lmdb.py / convert_h5_to_lmdb.py)

One CLI (`python -m revisionllm_tpu_torch.data.converters <kind> ...`)
replaces the per-dataset scripts. A host copy of
revisionllm_tpu/data/converters.py, so that the port never imports the JAX
package.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from revisionllm_tpu_torch.data.feature_store import RvfsWriter

GROUNDING_PROMPT = "During which frames can we see {}?"

EVENT_CAPTION_RE = [
    re.compile(p, re.IGNORECASE)
    for p in [
        r"can you describe what occurred from <s(.+?)> to <e(.+?) in the video\?",
        r"could you tell me what happened from <s(.+?)> to <e(.+?) in the video\?",
        r"what transpired from <s(.+?)> to <e(.+?) in the video\?",
        r"describe what took place from <s(.+?)> to <e(.+?) in the video\.",
        r"tell me about the events from <s(.+?)> to <e(.+?) in the video\.",
        r"what was going on from <s(.+?)> to <e(.+?) in the video\?",
        r"please recount what occurred from <s(.+?)> to <e(.+?) in the video\.",
        r"explain what happened from <s(.+?)> to <e(.+?) in the video\.",
        r"provide details about the events from <s(.+?)> to <e(.+?) in the video\.",
        r"share what transpired from <s(.+?)> to <e(.+?) in the video\.",
    ]
]
TEMPORAL_GROUNDING_RE = [
    re.compile(p, re.IGNORECASE)
    for p in [
        r"during which frames can we see (.+?) happening in the video\?",
        r"between which frames is (.+?) visible in the video\?",
        r"at what point in the video can we observe (.+?) taking place\?",
        r"between which two frames can we witness (.+?) occurring in the video\?",
        r"during which frames in the video can we observe (.+?) happening\?",
        r"at which time interval in the video can we see (.+?) occurring\?",
        r"between which frames can we find (.+?) taking place in the video\?",
        r"at what point in the video can we witness (.+?) happening\?",
        r"between which two frames in the video can we observe (.+?) taking place\?",
        r"during which frames does (.+?) occur in the video\?",
    ]
]


def _record(query_id, vid, sentence, s, e, duration, source) -> dict:
    sentence = sentence.strip().lower()
    if sentence.endswith("."):
        sentence = sentence[:-1]
    return {
        "query_id": query_id,
        "id": vid,
        "conversations": [
            {"from": "human", "value": "<video>\n" + GROUNDING_PROMPT.format(sentence)},
            {"from": "gpt", "value": "From <s0> to <e0>."},
        ],
        "meta": {"duration": duration, "token": {"<s0>": round(s, 1), "<e0>": round(e, 1)}},
        "source": source,
    }


def mad_to_records(mad_data: Dict[str, dict], neg: bool = False) -> List[dict]:
    """MAD_{train,val,test}.json -> records (parity: mad_to_activitynet.py:43-76;
    with neg=True every record is duplicated, mirroring the --neg flag)."""
    out = []
    for key, value in mad_data.items():
        rec = _record(
            key, value["movie"], value["sentence"],
            value["timestamps"][0], value["timestamps"][1],
            value["movie_duration"], "mad",
        )
        out.append(rec)
        if neg:
            rec["neg"] = "yes"
            out.append(rec)
    return out


def chapters_to_records(
    chapters_data: List[dict], feat_dir: Optional[str] = None
) -> List[dict]:
    """VidChapters VMR jsonl -> records (parity: chapters_to_activitynet.py:47-84;
    entries whose feature file is missing are skipped when feat_dir given)."""
    out = []
    for item in chapters_data:
        for i, (query, window) in enumerate(zip(item["query"], item["relevant_windows"])):
            if feat_dir is not None and not os.path.isfile(
                os.path.join(feat_dir, item["vid"] + ".npy")
            ):
                continue
            out.append(
                _record(
                    f"{item['vid']}_{i}", item["vid"], query,
                    window[0][0], window[0][1], item["duration"], "vidchapters7m",
                )
            )
    return out


def activitynet_to_records(anet_data: Dict[str, dict]) -> List[dict]:
    """ActivityNet captions {vid: {duration, timestamps, sentences}} -> records."""
    out = []
    for vid, value in anet_data.items():
        for i, (ts, sent) in enumerate(zip(value["timestamps"], value["sentences"])):
            out.append(
                _record(f"{vid}_{i}", vid, sent, ts[0], ts[1], value["duration"], "activitynet")
            )
    return out


def stage2_to_records(stage2_data: List[dict]) -> List[dict]:
    """Mine grounding pairs out of VTimeLLM stage-2 dialogues
    (parity: stage2_to_activitynet.py:70-139): skip pure-span answers and
    caption-template questions; extract (sentence, <sN>, <eN>) pairs either
    from grounding-template questions or from span-annotated captions."""
    out = []
    for item in stage2_data:
        convs = item["conversations"]
        for sid in range(0, len(convs) - 1, 2):
            q = convs[sid]["value"].strip().lower().replace("<video>\n", "")
            a = convs[sid + 1]["value"].strip().lower()
            if any(p.search(q) for p in EVENT_CAPTION_RE):
                continue
            sentence = None
            for p in TEMPORAL_GROUNDING_RE:
                m = p.search(q)
                if m:
                    sentence = m.group(1)
                    break
            if sentence is None:
                continue
            m = re.search(r"from <s(\d+)> to <e(\d+)>", a)
            if not m:
                continue
            n = m.group(1)
            if f"<s{n}>" not in item.get("meta", {}).get("token", {}):
                continue
            tok = item["meta"]["token"]
            out.append(
                {
                    "query_id": f"{item['id']}_{sid}",
                    "id": item["id"],
                    "conversations": [
                        {"from": "human", "value": "<video>\n" + GROUNDING_PROMPT.format(sentence)},
                        {"from": "gpt", "value": f"From <s{n}> to <e{n}>."},
                    ],
                    "meta": {
                        "duration": item["meta"]["duration"],
                        "token": {"<s0>": tok[f"<s{n}>"], "<e0>": tok[f"<e{n}>"]},
                    },
                    "source": "stage2",
                }
            )
    return out


def msrvtt_to_records(
    msrvtt_data: dict, train_ids: Optional[List[str]] = None, neg: bool = False
) -> List[dict]:
    """MSRVTT retrieval captions -> yes/no retrieval records (parity:
    msrvtt_retrieval_to_activitynet.py:32-70 — 'During which video can we see
    {caption}?' with answer 'yes'; no meta/token block)."""
    out = []
    id_set = set(train_ids) if train_ids is not None else None
    for value in msrvtt_data["sentences"]:
        if id_set is not None and value["video_id"] not in id_set:
            continue
        sentence = value["caption"].strip().lower()
        if sentence.endswith("."):
            sentence = sentence[:-1]
        rec = {
            "query_id": value["sen_id"],
            "id": value["video_id"],
            "conversations": [
                {
                    "from": "human",
                    "value": "<video>\nDuring which video can we see {}?".format(sentence),
                },
                {"from": "gpt", "value": "yes"},
            ],
            "source": "msrvtt",
        }
        out.append(rec)
        if neg:
            rec["neg"] = "yes"
            out.append(rec)
    return out


def npy_dir_to_rvfs(npy_dir: str, out_path: str) -> int:
    """Feature dir -> single RVFS store (replaces convert_npy_to_lmdb.py)."""
    n = 0
    with RvfsWriter(out_path) as w:
        for path in sorted(glob.glob(os.path.join(npy_dir, "*.npy"))):
            key = os.path.splitext(os.path.basename(path))[0]
            w.add(key, {"features": np.load(path)})
            n += 1
    return n


def h5_to_rvfs(h5_path: str, out_path: str, dataset_key: Optional[str] = None) -> int:
    """One big h5 (MAD's distribution format: one dataset per movie id) ->
    single RVFS store. Replaces reference data/convert_h5_to_lmdb.py:1-37
    (h5 items -> lmdb npz records named 'features', float32).

    dataset_key: convert only that item (sharding / debugging)."""
    import h5py  # imported here: the module imports without it

    n = 0
    with h5py.File(h5_path, "r") as f, RvfsWriter(out_path) as w:
        keys = [dataset_key] if dataset_key else list(f.keys())
        for key in keys:
            item = f[key]
            if isinstance(item, h5py.Group):
                # structured record (e.g. text features with
                # token_features/cls_features members) -> keep member names
                w.add(key, {
                    sub: np.asarray(item[sub], dtype=np.float32) for sub in item
                })
            else:
                w.add(key, {"features": np.asarray(item, dtype=np.float32)})
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset converters")
    p.add_argument(
        "kind",
        choices=["mad", "chapters", "activitynet", "stage2", "msrvtt",
                 "npy2rvfs", "h52rvfs"],
    )
    p.add_argument("--in_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--feat_dir", default=None)
    p.add_argument("--dataset_key", default=None,
                   help="h52rvfs: convert a single h5 item")
    p.add_argument("--neg", action="store_true")
    args = p.parse_args(argv)

    if args.kind == "npy2rvfs":
        n = npy_dir_to_rvfs(args.in_path, args.out_path)
        print(f"wrote {n} records to {args.out_path}")
        return

    if args.kind == "h52rvfs":
        n = h5_to_rvfs(args.in_path, args.out_path, args.dataset_key)
        print(f"wrote {n} records to {args.out_path}")
        return

    if args.in_path.endswith(".jsonl"):
        with open(args.in_path) as f:
            data = [json.loads(line) for line in f]
    else:
        data = json.load(open(args.in_path))
        if isinstance(data, dict) and "videos" in data:
            data = data["videos"]

    if args.kind == "mad":
        records = mad_to_records(data, neg=args.neg)
    elif args.kind == "chapters":
        records = chapters_to_records(data, args.feat_dir)
    elif args.kind == "activitynet":
        records = activitynet_to_records(data)
    elif args.kind == "msrvtt":
        records = msrvtt_to_records(data, neg=args.neg)
    else:
        records = stage2_to_records(data)

    with open(args.out_path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {args.out_path}")


if __name__ == "__main__":
    main()
