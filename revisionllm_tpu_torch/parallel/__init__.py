"""Multi-process serving and training over torch.distributed.

Counterpart of revisionllm_tpu/parallel/: `launch` starts the process group
(torchrun's environment or explicit arguments) and spawns ranks, `mesh`
names the (data, fsdp, tensor) axes over a DeviceMesh, `comm` holds the
collectives and Megatron's region functions, `sharding` the JAX package's
spec trees and each rank's local shards, `serve` the sharded generate, and
`dryrun` a CPU check of all of it in gloo ranks.
"""
