"""The benchmark's own library: cell lookup, inputs and weights from the
seed, the tokenizer and prompt template, the traffic generator, the
profiler reading and the roofline arithmetic. It imports nothing of the
program (revisionllm_tpu_torch), so the plain references may use it."""
