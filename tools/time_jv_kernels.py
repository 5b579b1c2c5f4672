#!/usr/bin/env python3
"""Device times of the PyTorch port's Hungarian kernels K1 and K3, as built
from one checkout of this repository.

    python3 tools/time_jv_kernels.py [CHECKOUT]

Imports the port's package from CHECKOUT (default: the checkout this script
is in), which builds that checkout's ``csrc/hungarian_jv.cu`` under its own
``build/``, then times ``lsap_lane`` (K1) at every shape of
``chip_smoke.K1_SHAPES`` and ``lsap_square`` (K3) on the square-padded copy
of [24, 40, 60], each on random, tie-heavy and BIG-padded costs made from a
fixed seed (the same in every checkout), with ``chip_smoke.device_ms`` of
this checkout.  Prints one JSON line: the card's name and power limit, the
checkout whose package ran and each time in ms.  Needs one CUDA device.

To compare two versions on one card, run both in one command, in turns:

    python3 tools/time_jv_kernels.py OLD; python3 tools/time_jv_kernels.py
    python3 tools/time_jv_kernels.py; python3 tools/time_jv_kernels.py OLD

The helpers of this checkout's ``chip_smoke.py`` then run on the other
checkout's package, which must have ``ops.hungarian.lsap_lane`` and
``lsap_square``, ``ops.matcher._square_pad`` and the timers that
``chip_smoke.py`` imports from ``utils/profiler.py`` (``device_ms`` and the
rest): an older checkout fails at that import.
"""
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
K3_SHAPE = (24, 40, 60)  # the long-clip evaluation step's problems, square-padded


def main() -> None:
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else REPO).resolve()
    sys.path.insert(0, str(checkout))  # the package under test comes from there ...
    from sound_event_detection_transformer_tpu_torch.ops import hungarian, matcher

    # ... and chip_smoke.py from here, whatever that checkout holds
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_jv_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    times = {}
    for kind in chip_smoke.K1_COST_KINDS:
        for shape in chip_smoke.K1_SHAPES:
            cost = chip_smoke.seeded_k1_cost(shape, kind, dev)
            times[f"K1 {list(shape)} {kind}"] = chip_smoke.device_ms(
                lambda: hungarian.lsap_lane(cost))
        square = matcher._square_pad(chip_smoke.seeded_k1_cost(K3_SHAPE, kind, dev))
        times[f"K3 {list(square.shape)} {kind}"] = chip_smoke.device_ms(
            lambda: hungarian.lsap_square(square))
    package = Path(hungarian.__file__).parents[2]  # the checkout whose kernels ran
    print(json.dumps({"card": chip_smoke.card_line(), "checkout": str(package), "ms": times}))


if __name__ == "__main__":
    main()
