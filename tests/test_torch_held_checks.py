"""`chip_smoke.py`'s hold of the kernels against their plain versions, on
the CPU: `DeferredChecks` (the queued output and cache comparisons) fails
exactly where a per-call `err <= tol` fails, a NaN error or bound included,
and `HeldLaunches` fails a block where a kernel's counter grew by a launch
that no shim saw, across a `zero_launches` fold. The card's run of these
helpers is `chip_smoke.py` itself; here fake wrappers stand in for the
kernels' counters."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(2)


def _pair(n: int, dtype=torch.bfloat16, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    ref = torch.randn(n, generator=g).to(dtype)
    return ref.clone(), ref


# (what is planted, where) -> the output and its plain version; the large
# output (past 2**20 elements) is reduced at once, the small ones stacked
PLANTS = ["nan_got", "nan_ref", "inf_got", "over_bound"]
SIZES = {"small": 64, "large": (1 << 20) + 8}


def _planted(plant: str, n: int):
    got, ref = _pair(n)
    if plant == "nan_got":
        got[n // 2] = float("nan")
    elif plant == "nan_ref":
        ref[n // 2] = float("nan")
    elif plant == "inf_got":
        got[n // 3] = float("inf")
    else:   # one element past KERNEL_REL of the largest magnitude
        got[n // 2] = ref[n // 2].float() + 4 * cs.KERNEL_REL[ref.dtype] * ref.float().abs().max()
    return got, ref


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("plant", PLANTS)
def test_deferred_close_fails_where_the_per_call_check_fails(plant, size):
    got, ref = _planted(plant, SIZES[size])
    per_call = cs.max_err(got, ref) <= cs.KERNEL_REL[ref.dtype] * float(ref.float().abs().max())
    assert not per_call
    checks = cs.DeferredChecks()
    for k in range(3):                       # good outputs around the planted one
        checks.close(f"good {k}", *_pair(SIZES[size], seed=k + 1))
    checks.close("planted", got, ref)
    with pytest.raises(RuntimeError, match="planted"):
        checks.verify()


@pytest.mark.parametrize("size", list(SIZES))
def test_deferred_close_passes_within_the_bound(size):
    checks = cs.DeferredChecks(flush_at=2, stack_at=2)    # flushes and stacks on the way
    for k in range(5):
        got, ref = _pair(SIZES[size], seed=k)
        got[0] = ref[0].float() + 0.5 * cs.KERNEL_REL[ref.dtype] * ref.float().abs().max()
        checks.close(f"call {k}", got, ref)
    checks.verify()
    assert not checks.pending and not checks.pairs


def test_deferred_flush_fails_a_planted_nan_before_the_end():
    checks = cs.DeferredChecks(flush_at=4, stack_at=2)
    got, ref = _planted("nan_got", 64)
    checks.close("planted", got, ref)
    with pytest.raises(RuntimeError, match="planted"):
        for k in range(16):                  # the queue fills and is read back
            checks.close(f"good {k}", *_pair(64, seed=k + 1))


@pytest.mark.parametrize("plant", ["flipped", "nan_both", "equal"])
def test_deferred_differ_is_bit_for_bit(plant):
    a = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    b = a.clone()
    codes = torch.arange(16, dtype=torch.int8)
    if plant == "flipped":
        b[2, 3] = torch.nextafter(b[2, 3], torch.tensor(1e9))
    elif plant == "nan_both":
        a[1, 1] = b[1, 1] = float("nan")
    checks = cs.DeferredChecks()
    checks.differ("cache", ((a, b), (codes, codes.clone())))
    if plant == "equal":
        checks.verify()
    else:
        with pytest.raises(RuntimeError, match="cache"):
            checks.verify()


def _wrapper(name: str, *attrs):
    def fn():
        pass
    fn.__name__ = name
    for a in attrs:
        setattr(fn, a, 0)
    return fn


def _ledger():
    grouped = _wrapper("grouped", "launches", "launches_wide")
    mm = _wrapper("mm", "launches")
    ledger = cs.HeldLaunches({grouped: [("g", "launches"), ("g_wide", "launches_wide")],
                              mm: [("mm", "launches")]})
    return ledger, grouped, mm


def _launch(fn, attr, n=1):
    setattr(fn, attr, getattr(fn, attr) + n)


@pytest.mark.parametrize("reset", [False, True], ids=["no-reset", "zero_launches-inside"])
def test_held_launches_every_launch_inside_a_shim(reset):
    ledger, grouped, mm = _ledger()
    _launch(mm, "launches", 5)               # before the block: not its business
    ledger.base = ledger._read()
    out, grown = ledger.around(grouped, lambda: (_launch(grouped, "launches_wide", 7),
                                                 _launch(grouped, "launches"), "o")[-1])
    assert out == "o" and grown == {"g": 1, "g_wide": 7}
    if reset:                                # what zero_launches does inside a block
        ledger.fold()
        for fn, attr in ((grouped, "launches"), (grouped, "launches_wide"), (mm, "launches")):
            setattr(fn, attr, 0)
    ledger.around(mm, lambda: _launch(mm, "launches", 3))
    assert ledger.check() == {"g": 1, "g_wide": 7, "mm": 3}


@pytest.mark.parametrize("reset", [False, True], ids=["no-reset", "zero_launches-inside"])
def test_held_launches_fails_a_launch_no_shim_saw(reset):
    ledger, grouped, mm = _ledger()
    ledger.around(mm, lambda: _launch(mm, "launches", 2))
    if reset:
        ledger.fold()
        setattr(mm, "launches", 0)
    _launch(grouped, "launches_wide")        # a call that bypassed the shims
    with pytest.raises(RuntimeError, match="g_wide"):
        ledger.check()
