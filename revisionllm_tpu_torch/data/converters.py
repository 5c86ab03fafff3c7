"""MAD annotations -> unified grounding records: the `mad_to_records` part
of revisionllm_tpu/data/converters.py, copied so that the port never
imports the JAX package (parity: reference
revisionllm/data/mad/mad_to_activitynet.py:43-76).

A record is {query_id, id, conversations: [human '<video>\n During which
frames...', gpt 'From <s0> to <e0>.'], meta: {duration, token: {<s0>,
<e0>}}, source}. The other converters and the RVFS store conversion wait.
"""

from __future__ import annotations

from typing import Dict, List

GROUNDING_PROMPT = "During which frames can we see {}?"

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
