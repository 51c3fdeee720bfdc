"""stringdecomposer-tpu: monomer string decomposition on JAX (CUDA kernels on NVIDIA GPUs).

Public API:
    run(...)              — full pipeline, reference-compatible TSV outputs
    decompose_reads(...)  — raw DP stage as a library call
    PipelineConfig        — pipeline knobs (scoring, windowing, batching)
"""

from .__version__ import __version__

__all__ = ["__version__", "run", "decompose_reads", "PipelineConfig"]


def __getattr__(name):
    # lazy: importing the package must not pull in jax (e.g. for --help)
    if name in ("run", "decompose_reads", "PipelineConfig"):
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
