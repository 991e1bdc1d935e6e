"""tpu_orc_torch — the PyTorch/CUDA port of tpu_orc for one NVIDIA H100.

A second package beside ``tpu_orc`` (the JAX reference, which stays as
it is). It imports ``torch`` and never ``jax``, and nothing of
``tpu_orc``: every module of ``tpu_orc`` that it needs is copied here
(each copy's docstring names the file it mirrors), with its device seam
changed where that module used JAX. Every Pallas kernel on the path
becomes a hand-written CUDA kernel (``csrc/``), built with ``nvcc`` at
first use (``_build.py``), with a plain PyTorch version beside it that
the CPU tests hold against ``tpu_orc``.

    io/        FASTQ/FASTA reader and writer, base encoding
    align/     locate (wavefront and Kogge-Stone), Myers and path-bits
               pileup: kernel wrappers and plain versions; the flag
               algebra (spec)
    native/    the C++ oracle (host scorer, consensus traceback)
    demux/     reorient, dual-round demux (fused on CUDA), primer clean,
               cutadapt-schema reports
    cluster/   scoring (Myers backends), sorter engine, consensus,
               union-find, writers
    rrna/      stage 05a: the profile-HMM Viterbi (kernel wrapper and
               plain version), HMMER3 and .cm parsing, 18S/28S finders
    pipeline/  stage graph of the COI and rRNA paths (run_all), qc,
               summary, stages 06-09
    dist/      the multi-device path: meshes of cards, the sharded demux
               and pairwise steps, multi-host on torch.distributed
    analysis/  figures, LCA, phylogeny, anchors, reports
    utils/     run metrics, the torch.profiler trace, prewarm
    synthetic  seeded synthetic banks and COI and rRNA plate reads (tests,
               smoke)
"""

__version__ = "0.1.0"
