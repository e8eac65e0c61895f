"""The multi-device layer and corpus-scale preprocessing: the port of
``torchaudio_contrib_tpu.parallel`` on ``torch.distributed``.

Meshes (``make_mesh``, ``make_pod_mesh``, ``initialize_multihost``),
batch data parallelism (``shard_batch``, ``replicate``, ``sharded_apply``,
``data_parallel``), the corpus preprocessor (one device, or a mesh's data
axis), time-sharded STFT and mel, tensor parallelism (``shard_params``),
FSDP (``fsdp_shard``), the GPipe pipeline (``pipeline_apply``) and
sequence-parallel ring attention (``ring_attention``, ``sp_*_apply``).
The collectives they share are in ``_comm``.
"""
from .sharding import (
    make_mesh, shard_batch, replicate, sharded_apply, data_parallel,
)
from .corpus import (
    StreamingSTFT, chunked_melspectrogram, CorpusPreprocessor, CorpusStats,
)
from .multihost import initialize_multihost, make_pod_mesh
from .timeshard import time_sharded_stft, time_sharded_melspectrogram
from .tp import tensor_parallel_specs, shard_params
from .fsdp import (
    fsdp_specs, fsdp_shard, fsdp_init, fsdp_state_specs)
from .pp import (
    stack_pipeline, unstack_pipeline, pipeline_shard,
    microbatch, unmicrobatch, build_pipeline, pipeline_apply)
from .spattn import ring_attention, sp_conformer_apply, \
    sp_wav2vec2_apply

__all__ = [
    "make_mesh", "shard_batch", "replicate", "sharded_apply",
    "data_parallel",
    "StreamingSTFT", "chunked_melspectrogram", "CorpusPreprocessor",
    "CorpusStats",
    "initialize_multihost", "make_pod_mesh",
    "time_sharded_stft", "time_sharded_melspectrogram",
    "tensor_parallel_specs", "shard_params",
    "fsdp_specs", "fsdp_shard", "fsdp_init", "fsdp_state_specs",
    "stack_pipeline", "unstack_pipeline", "pipeline_shard",
    "microbatch", "unmicrobatch", "build_pipeline", "pipeline_apply",
    "ring_attention", "sp_conformer_apply", "sp_wav2vec2_apply",
]
