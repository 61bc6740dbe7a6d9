"""The test suite's xdist schedule.

Under `-n N --dist loadfile`, xdist hands each test file whole to one worker.
`pytest_xdist_make_scheduler` below changes only the unit of work: a file in
SPREAD_FILES is handed out one test at a time, so a long file no longer sets
the suite's wall time alone.  Without xdist, and under any other `--dist`,
xdist's own scheduler runs.
"""

import pytest

# A file goes here only if it has no module- or session-scoped fixture that
# shares state between its tests: the port's files do (test_torch_parallel.py's
# 4 gloo ranks), so they stay one unit each.
SPREAD_FILES = ("tests/test_multigrid.py",)

# Tests that go to one worker as one unit, one after the other: each grows
# its process to 20 GiB or more, which the process holds until it exits, and
# two of them on two workers at once took a 6-worker run to 57 of the host's
# 63 GiB.
RUN_TOGETHER = (
    "tests/test_multigrid.py::test_mg_fused_smoother_solve_parity",
    "tests/test_multigrid.py::test_mg_smoother_residual_reuse",
)

# Units of work that go out first, longest first (a file stands for itself
# as one unit); every other unit follows in xdist's own order, by test count.
# The seconds are each unit's test time in a 6-worker tier-1 run on 8 cores.
LONGEST_FIRST = (
    RUN_TOGETHER[0],  # 1003
    "tests/test_multigrid.py::test_mg_precond_dtype_bf16_factored",  # 483
    "tests/test_workloads.py",  # 472
    "tests/test_multigrid.py::test_in_band_solve_stats_and_backward_probe",  # 221
    "tests/test_multigrid.py::test_mg_stencil_pallas_config_matches_stencil",  # 175
    "tests/test_multigrid.py::test_mg_fused_matvec",  # 171
    "tests/test_multigrid.py::test_fused_smoother_matches_xla_smoother",  # 163
    "tests/test_multigrid.py::test_vcycle_accelerates_fgmres",  # 63
    "tests/test_multigrid.py::test_mg_layer_matches_dense_evolution",  # 45
    "tests/test_multigrid.py::test_gl_shaped_preconditioner_quality_guard",  # 43
    "tests/test_multigrid.py::test_mg_layer_gradients_descent",  # 36
    "tests/test_multigrid.py::test_mg_3d_small",  # 31
    "tests/test_multigrid.py::test_mg_layer_gradients_match_fd_well_conditioned",  # 21
    "tests/test_multigrid.py::test_mg_precond_dtype_bf16",  # 21
    "tests/test_multigrid.py::test_mg_layer_matches_dense",  # 18
)
_RANK = {unit: i for i, unit in enumerate(LONGEST_FIRST)}


def work_unit(nodeid):
    """The unit of work `nodeid` belongs to under `--dist loadfile`."""
    if nodeid in RUN_TOGETHER:
        return RUN_TOGETHER[0]
    path = nodeid.split("::", 1)[0]
    return nodeid if path in SPREAD_FILES else path


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongestFirstScheduling(LoadFileScheduling):
        _ranked = False

        def _split_scope(self, nodeid):
            return work_unit(nodeid)

        def _assign_work_unit(self, node):
            # `schedule` fills the queue, then assigns from its front: rank
            # the queue once, before its first unit goes out
            if not self._ranked:
                for unit in sorted(self.workqueue, key=lambda u: _RANK.get(u, len(_RANK))):
                    self.workqueue.move_to_end(unit)
                self._ranked = True
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            # xdist tops a worker up while 2 or fewer of its tests are
            # pending; a worker runs a test once it holds the next one, so
            # top up at 1: the worker given RUN_TOGETHER starts with no
            # third test queued behind its two
            if self.workqueue and self._pending_of(self.assigned_work[node]) > 1:
                return
            super()._reschedule(node)

    return LongestFirstScheduling(config, log)
