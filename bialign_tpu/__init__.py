"""bialign_tpu — a bi-alignment framework for accelerators (NVIDIA GPUs
through JAX).

A from-scratch rebuild of the capabilities of s-will/BiAlign (reference:
/root/reference): optimal simultaneous sequence + structure alignment of RNA
or protein pairs with bounded shifts, affine gap costs and shift penalties
(Waldl et al., CIBB 2019).

Architecture (a redesign for array hardware, not a port):

* the 4D banded DP (reference Cython fill loops, bialignment.pyx:443-509)
  becomes static integer case tables (:mod:`bialign_tpu.ops.cases`) driving
  interchangeable engines: a numpy oracle
  (:mod:`bialign_tpu.ops.reference_dp`), a C++ host engine
  (:mod:`bialign_tpu.ops.native_dp`), an XLA anti-diagonal wavefront scan
  (:mod:`bialign_tpu.ops.xla_dp`), and a one-launch CUDA wavefront kernel
  (:mod:`bialign_tpu.ops.cuda_dp`); :mod:`bialign_tpu.backend` picks the
  engine per platform;
* scoring matrices are dense int32 tables (:mod:`bialign_tpu.scoring`),
  so the device DP is pure integer arithmetic and bit-exact;
* traceback walks the filled band in exact reference order, on the
  device for the JAX engines (:mod:`bialign_tpu.ops.device_traceback`);
* batching / multi-device data parallelism live in
  :mod:`bialign_tpu.parallel`.

The public API mirrors the reference package ``bialignment`` so that users
can switch with an import change.
"""

from .version import __version__
from .aligner import BiAligner
from .config import AlignConfig
from .models.triplet import BiAlignerTriplet
from .io.simmatrix import blosum62, materialize_matrix, read_simmatrix
from .io.cfssp import read_molecule, read_molecule_from_file
from .io.structure_files import (
    read_dssp,
    read_dssp_file,
    read_stride,
    read_stride_file,
)
from .scoring.structure import (
    consensus_sbpp,
    consensus_sequence,
    highlight_sequence_identity,
    highlight_structure_identity,
    highlight_structure_similarity,
    mea,
    parse_dotbracket,
)
from .render.plot import breaklines, fourway_from_full, plot_alignment, runs

__all__ = [
    "__version__",
    "AlignConfig",
    "BiAligner",
    "BiAlignerTriplet",
    "blosum62",
    "materialize_matrix",
    "read_simmatrix",
    "read_molecule",
    "read_molecule_from_file",
    "read_dssp",
    "read_dssp_file",
    "read_stride",
    "read_stride_file",
    "mea",
    "parse_dotbracket",
    "consensus_sequence",
    "consensus_sbpp",
    "highlight_sequence_identity",
    "highlight_structure_identity",
    "highlight_structure_similarity",
    "breaklines",
    "fourway_from_full",
    "plot_alignment",
    "runs",
]
