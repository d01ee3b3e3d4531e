"""The check ``profile_superstep.py`` makes of a profile's device records,
on the CPU: a profile with no CUDA work agrees with zero launches, and a
kernel whose logical launches have no device records is reported, in
either mode, with each of its CUDA functions; the functions it expects
are exactly the ``__global__`` functions of each kernel's source (K4: one,
``alpha_search_pass``; K7 and the two scans too).  (On the card the same check also holds the
device's kernel records to the host's launch calls.)"""
from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import audit
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _profile_superstep():
    spec = importlib.util.spec_from_file_location(
        "profile_superstep", ROOT / "profile_superstep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PS = _profile_superstep()


def _cpu_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (torch.ones(64) * 2).sum()
    return prof


def test_no_launches_no_records_agree():
    prof = _cpu_profile()
    assert audit.launch_records(prof) == ([], [])
    assert PS.launch_check(torch, prof, {k: 0 for k in ops.KERNELS}) == {}


@pytest.mark.parametrize("kernel", sorted(ops.CUDA_FUNCTIONS))
def test_missing_records_are_reported(kernel):
    prof = _cpu_profile()
    logical = {k: 0 for k in ops.KERNELS}
    logical[kernel] = 2
    if kernel + "_bf16" in logical:
        logical[kernel + "_bf16"] = 1      # both modes run the same code
    want = 2 + (kernel + "_bf16" in logical)
    assert PS.launch_check(torch, prof, logical) == {
        fn: [0, want] for fn in ops.CUDA_FUNCTIONS[kernel]}


GLOBAL = re.compile(r"__global__\s+void(?:\s+__launch_bounds__\("
                    r"(?:[^()]|\([^()]*\))*\))?\s+(\w+)\(")


@pytest.mark.parametrize("kernel", sorted(ops.CUDA_FUNCTIONS))
def test_cuda_functions_are_the_sources_kernels(kernel):
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / f"{kernel}.cu").read_text()
    assert set(GLOBAL.findall(src)) == set(ops.CUDA_FUNCTIONS[kernel])
