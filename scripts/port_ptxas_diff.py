"""Each CUDA kernel instance's registers and spills (ptxas -v, as
chip_smoke.py's phase 2 prints them) in this checkout against another
checkout's, e.g. the parent commit unpacked under build/archive/: both
libraries are built here (ops/_build.py, one nvcc per source), then the
instances of the other checkout whose registers and spills are the same
here, those that differ, those it alone has (kernels replaced here) and
the instances only this checkout has; exits 1 where an instance both
have differs.  Needs
nvcc (run it on a card's machine); imports no jax:

    PYTHONPATH=. python3 scripts/port_ptxas_diff.py OTHER_DIR
"""
import importlib.util
import sys
from pathlib import Path

import chip_smoke


def usage(root):
    """{kernel instance: (registers, spill bytes)} of root's build."""
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(str(root)))}",
        Path(root) / "libllsm2_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.library()
    return {chip_smoke.kernel_label(n): (r, s)
            for n, r, s, _ in mod.resource_usage()}


def main(argv):
    if len(argv) != 1:
        print(__doc__, flush=True)
        return 2
    mine, other = usage(Path(".").resolve()), usage(Path(argv[0]).resolve())
    same = [k for k in other if mine.get(k) == other[k]]
    diff = {k: (other[k], mine[k]) for k in other
            if k in mine and mine[k] != other[k]}
    gone = {k: v for k, v in other.items() if k not in mine}
    new = {k: v for k, v in mine.items() if k not in other}
    print(f"{len(same)} of {len(other)} kernel instances of {argv[0]} have "
          f"the same registers and spills here; differ (there, here): "
          f"{diff}", flush=True)
    print(f"only there, replaced here (registers, spill bytes): {gone}",
          flush=True)
    print(f"only here (registers, spill bytes): {new}", flush=True)
    return 0 if not diff else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
