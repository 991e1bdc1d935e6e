"""tpu_orc_torch — the PyTorch/CUDA port of tpu_orc for one NVIDIA H100.

A second package beside ``tpu_orc`` (the JAX reference, which stays as
it is). It imports ``torch`` and never ``jax``: host modules of
``tpu_orc`` that import no JAX are reused as they are, the ones that do
are copied here with their device seam changed, and every Pallas kernel
on the path becomes a hand-written CUDA kernel (``csrc/``), built with
``nvcc`` at first use (``_build.py``), with a plain PyTorch version
beside it that the CPU tests hold against ``tpu_orc``.

    align/     locate + Myers: kernel wrappers and plain versions
    demux/     reorient, dual-round demux (fused on CUDA), primer clean
    cluster/   scoring (Myers backends), sorter engine, writers
    pipeline/  stage graph of the COI main path (run_all)
    synthetic  seeded synthetic banks and plate reads (tests, smoke)
"""

__version__ = "0.1.0"
