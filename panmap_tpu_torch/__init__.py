"""panmap_tpu_torch: the PyTorch/CUDA port of panmap_tpu.

The single-sample path (index -> place -> align -> genotype -> consensus)
and metagenomic abundance (--meta) on one NVIDIA GPU.  The device-bound
layers live here:

 - place/    the placement scorer as torch ops (TorchPlacer), with the exact
             f64 host rescue carried over from panmap_tpu.place.query_tpu;
 - align/    the banded Smith-Waterman scoring kernel (csrc/banded_sw.cu),
             the long-read DP kernel (csrc/banded_long.cu) and the aligner
             stages that feed them;
 - meta/     the presence-bitmap read scorer (TorchMetaScorer), the SQUAREM
             EM and the --meta driver, as torch ops;
 - pipeline  the stage runner; __main__ the CLI.

Every host layer (index, io, native, sketch, the f64 placement engine, the
aligner front end, genotyping, BAM/VCF writers) is imported from panmap_tpu,
which stays the reference the port is tested against.  This package imports
torch and never jax.
"""

import os as _os

__version__ = "0.1.0"

# panmap_tpu's package init turns on JAX's persistent compile cache, and so
# imports jax, whenever JAX_PLATFORMS names an accelerator (CUDA hosts with
# jax installed set JAX_PLATFORMS=cuda,cpu).  The port never uses jax:
# switch that off before any panmap_tpu module loads.
_os.environ["PANMAP_TPU_COMPILE_CACHE"] = ""
