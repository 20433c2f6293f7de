"""The kernel wrappers' shared tensor contracts (ops/kernel_build.py):
check_rays, check_tensors and check_order, on the CPU."""

import pytest
import torch

from svo_raytracer_torch.ops import kernel_build


def _rays(B=5):
    return (torch.zeros(B, 3), torch.ones(B, 3),
            torch.ones(B, dtype=torch.bool))


def test_check_rays_accepts_and_returns_B():
    packed = torch.zeros(7, dtype=torch.int32)
    assert kernel_build.check_rays(*_rays(), "cpu",
                                   ("packed", packed, torch.int32)) == 5
    table = torch.zeros(2, 4, dtype=torch.int16)       # any dtype
    assert kernel_build.check_rays(*_rays(0), "cpu",
                                   ("attr_comb", table, None)) == 0


@pytest.mark.parametrize("case", [
    "device type", "origins shape", "directions shape", "alive shape",
    "origins dtype", "alive dtype", "strided origins", "table dtype",
    "strided table", "table device"])
def test_check_rays_rejects(case):
    o, d, alive = _rays()
    table = torch.zeros(8, dtype=torch.int32)
    device_type = "cpu"
    if case == "device type":
        device_type = "cuda"
    elif case == "origins shape":
        o = o[:, :2].contiguous()
    elif case == "directions shape":
        d = d[:4]
    elif case == "alive shape":
        alive = alive[:, None]
    elif case == "origins dtype":
        o = o.double()
    elif case == "alive dtype":
        alive = alive.to(torch.uint8)
    elif case == "strided origins":
        o = torch.zeros(3, 5).t()
    elif case == "table dtype":
        table = table.long()
    elif case == "strided table":
        table = table[::2]
    else:
        table = table.to("meta")
    with pytest.raises(ValueError):
        kernel_build.check_rays(o, d, alive, device_type,
                                ("table", table, torch.int32))


def test_check_tensors_strided_takes_any_strides():
    row = torch.zeros(1, 3).expand(6, 3)
    kernel_build.check_tensors(
        torch.device("cpu"), ("t", torch.zeros(6), (6,), torch.float32),
        strided=[("o", row, (6, 3), torch.float32)])
    with pytest.raises(ValueError, match="o must be a contiguous"):
        kernel_build.check_tensors(torch.device("cpu"),
                                   ("o", row, (6, 3), torch.float32))
    with pytest.raises(ValueError,
                       match=r"o must be a \(6, 3\) torch.float32"):
        kernel_build.check_tensors(
            torch.device("cpu"),
            strided=[("o", row.double(), (6, 3), torch.float32)])


def test_check_order():
    cpu = torch.device("cpu")
    kernel_build.check_order(None, 4, cpu)
    kernel_build.check_order(torch.arange(4), 4, cpu)
    for bad in (torch.arange(5), torch.arange(4, dtype=torch.int32),
                torch.arange(8)[::2]):
        with pytest.raises(ValueError):
            kernel_build.check_order(bad, 4, cpu)
