"""Tests that need the card (marker `chip`; they skip without a CUDA
device): the application counts of work/multigrid.py against the port's own
launch counters on today's code, and the control and the program with its
networks below float32 at the cell's own size coming out not correct.

    python3 -m pytest perfbench/tests/test_pb_chip.py -q     (on the chip)"""

import pytest
import torch

from perfbench import calibrate
from perfbench.lib import compare, harness
from perfbench.work import multigrid


@pytest.mark.chip
def test_applications_match_the_launch_counters(cuda):
    from mech_nn_discovery_pde_torch.ops import _cuda

    tr = harness.build("gl-train", 2147483701, cuda)
    tr.check_steps(1)
    tr.trace_on()
    _cuda.LAUNCHES.clear()
    tr.step()
    torch.cuda.synchronize()
    its = tr.iterations()
    ops = multigrid.ops(tr.ctx.config, its, 1)
    launches = dict(_cuda.LAUNCHES)
    k1 = sum(v for k, v in launches.items() if k.startswith("k1_"))
    k2 = sum(v for k, v in launches.items() if k.startswith("k2_"))
    assert k1 == sum(o.count for o in ops if o.name.startswith("k1."))
    assert k2 == sum(o.count for o in ops if o.name.startswith("k2."))


@pytest.mark.chip
def test_the_graphed_gl_field_is_the_eager_one(cuda):
    from perfbench.lib.common import load_module

    f = {"nt": 4, "nx": 128, "ny": 128, "t_step": 0.1, "domain": 50.0, "a": 0.0, "b": -1.5,
         "substeps": 10, "skip": 2.0}
    gl = load_module("inputs", "gl")
    assert torch.equal(gl._field(f, 7, cuda, graph=True), gl._field(f, 7, cuda, graph=False))


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["gl-train", "burgers-train"])
@pytest.mark.parametrize("seed", [2147483713, 2147483719, 2147483723])
def test_the_control_is_not_correct(cuda, cell, seed):
    # the reference computed one step below each stated precision, in the
    # program's place
    limits = harness.load_cell(cell)["limits"]
    values = calibrate.readings(cell, seed, "reference-lower", cuda)
    print(cell, seed, values)
    assert not compare.passed(compare.checks(values, limits))


@pytest.mark.chip
@pytest.mark.parametrize("cell, variant", [("burgers-train", "tf32"),
                                           ("burgers-train", "lower:bf16_networks"),
                                           ("gl-train", "lower:bf16_networks")])
@pytest.mark.parametrize("seed", [2147483713, 2147483719, 2147483723])
def test_networks_below_float32_are_not_correct(cuda, cell, variant, seed):
    # the program with its networks below the stated float32 (GL's one-row
    # ParamNet products come out of cuBLAS alike with TF32 allowed or not)
    limits = harness.load_cell(cell)["limits"]
    values = calibrate.readings(cell, seed, variant, cuda)
    print(cell, seed, values)
    assert not compare.passed(compare.checks(values, limits))
