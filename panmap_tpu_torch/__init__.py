"""panmap_tpu_torch: the PyTorch/CUDA port of panmap_tpu.

The single-sample path (index -> place -> align -> genotype -> consensus)
and metagenomic abundance (--meta) on NVIDIA GPUs, as a package of its
own: it imports torch, numpy and the standard library, never jax and
nothing of panmap_tpu (the JAX package stays the reference the port is
tested against; only the tests import both).

Device layers, written for the GPU:

 - place/    the placement scorer as torch ops (TorchPlacer in
             query_torch.py over metrics.py and engine_torch.py), with the
             exact f64 host rescue;
 - align/    the banded Smith-Waterman scoring kernel (csrc/banded_sw.cu
             behind sw.py), the long-read DP kernel (csrc/banded_long.cu
             behind long_dp.py) and the aligner stages that feed them
             (batch.py, longread.py);
 - meta/     the presence-bitmap read scorer (engine_torch.py), the SQUAREM
             EM (em.py) and the --meta driver (driver.py);
 - parallel/ --mesh and --dist-*: the mesh of shards whose partial sums
             reduce over torch.distributed (mesh.py), the gloo process
             group (dist.py);
 - pipeline  the stage runner; __main__ the CLI; _kernels the nvcc build;
             trace the spans of the stages, kept while a torch.profiler
             session records (--profile).

Host layers, carried over from panmap_tpu under the same sub-package and
file names (each without its jax parts): utils/fastnp, sketch/cpu, io/
(capnp, panman, fastq, index_io, refidx, bam), ux, native/ (the C++ host
library, built with g++ at first use into _build/), align/ (core, adna,
bwt), index/builder, simulate, tools, place/ (engine, refine), genotype/
(caller, baq, indel), meta/ (index, events, rdg, engine).  convert.py
turns index and sketch state into plain dicts and back, which is how the
parity tests hand one workload to both packages.

Importing the package tunes the host allocator as panmap_tpu's own init
does (_tune_host_memory): the host stages allocate and free buffers of
hundreds of MB (the long-read direction bytes alone are 6 GB a run), and
faulting those pages in again on every allocation is what they would
otherwise spend most of their time on.
"""

__version__ = "0.1.0"


def _tune_host_memory():
    """Disable numpy's MADV_HUGEPAGE on large buffers (must run before numpy
    is first imported).  On VMs with synchronous THP compaction, every fresh
    huge-page fault costs ~100ms+, which made large one-shot numpy
    allocations (np.empty + first write) run at ~10 MB/s instead of ~2 GB/s —
    a 10-30x slowdown of every host-side array stage.  Override by setting
    NUMPY_MADVISE_HUGEPAGE yourself."""
    import os
    import sys

    if "numpy" not in sys.modules:
        os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    elif os.environ.get("NUMPY_MADVISE_HUGEPAGE") is None:
        # numpy already imported (e.g. by sitecustomize) — runtime switch
        try:
            try:
                from numpy._core import multiarray as _ma
            except ImportError:  # numpy < 2
                from numpy.core import multiarray as _ma
            _ma._set_madvise_hugepage(False)
        except Exception:
            pass
    # keep large freed buffers on the heap instead of returning them to the
    # OS (re-faulting them back in is the expensive part)
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_host_memory()
