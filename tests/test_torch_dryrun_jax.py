"""dryrun_multichip over 4 gloo ranks against JAX's 4-device
sharded_gltf_frame: tests/test_torch_entry.py::test_dryrun_matches_jax at
n = 4, in a file of its own so that xdist's loadfile runs it beside the
n = 2 case (each takes ~4 min on the CPU, most of it XLA compiling JAX's
sharded light-space frame). Gates as there: rgba within 3/255 on all but
0.2% of the pixels, and the perf-mode frame on one device differs from
the sharded one in both packages.
"""

import contextlib
import io

from funky_tpu_torch import entry

from .test_torch_entry import check_dryrun_matches_jax


def test_dryrun_matches_jax_on_4_ranks():
    with contextlib.redirect_stdout(io.StringIO()):
        out = entry.dryrun_multichip(4, device="cpu")
    check_dryrun_matches_jax(out, 4)
