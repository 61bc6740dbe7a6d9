"""The suite's own xdist schedule (the repo's top-level `conftest.py`): under
`--dist loadfile` each test of a file in SPREAD_FILES is a unit of work of
its own, but RUN_TOGETHER's tests share one, every other file stays one
unit, and the units named in LONGEST_FIRST go out first, in that order.  No
worker is started: the scheduler is fed a collection and fake worker nodes."""

import ast
import importlib.util
from pathlib import Path

import pytest

# loaded by its path: pytest imports every conftest under the one module name
_SPEC = importlib.util.spec_from_file_location("suite_schedule", Path(__file__).resolve().parents[1] / "conftest.py")
schedule = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(schedule)

MG = "tests/test_multigrid.py"
PARALLEL = "tests/test_torch_parallel.py"


class _Config:
    def __init__(self, dist, workers=2):
        self._values = {"dist": dist, "tx": [f"{workers}*popen"]}
        self.option = type("Option", (), {"loadscopereorder": True})()

    def getvalue(self, name):
        return self._values[name]


class _Node:
    gateway = type("Gateway", (), {"id": "gw"})()

    def __init__(self, collection, log):
        self.collection = collection
        self.shutting_down = False
        self.sent = []
        self.log = log

    def send_runtest_some(self, indices):
        self.sent.append([self.collection[i] for i in indices])
        self.log.append(self.sent[-1])

    def shutdown(self):
        self.shutting_down = True


def _scheduler(workers=2):
    return schedule.pytest_xdist_make_scheduler(config=_Config("loadfile", workers), log=None)


def test_spread_file_tests_are_units_of_their_own():
    sched = _scheduler()
    spread = [u for u in schedule.LONGEST_FIRST if u.startswith(MG + "::")]
    assert len(spread) > 2
    for nodeid in spread:
        assert sched._split_scope(nodeid) == nodeid
    assert {sched._split_scope(n) for n in schedule.RUN_TOGETHER} == {schedule.RUN_TOGETHER[0]}


def test_module_fixture_file_stays_one_unit():
    sched = _scheduler()
    for nodeid in (f"{PARALLEL}::test_ranks_import_no_jax", f"{PARALLEL}::test_halo_derivative_matches_jax"):
        assert sched._split_scope(nodeid) == PARALLEL
    assert PARALLEL not in schedule.SPREAD_FILES


def test_named_files_and_tests_exist(request):
    root = request.config.rootpath
    for path in schedule.SPREAD_FILES:
        assert (root / path).is_file(), path
    for unit in schedule.LONGEST_FIRST + schedule.RUN_TOGETHER:
        path, _, name = unit.partition("::")
        assert (root / path).is_file(), unit
        if name:
            tree = ast.parse((root / path).read_text())
            assert name in {f.name for f in tree.body if isinstance(f, ast.FunctionDef)}, unit


def test_longest_first_order():
    together = list(schedule.RUN_TOGETHER)
    ranked = [u for u in schedule.LONGEST_FIRST[1:] if u.startswith(MG + "::")][:3]
    workloads = "tests/test_workloads.py::test_sine_fit_converges"
    misc = [f"tests/test_misc.py::test_{i}" for i in range(4)]
    parallel = [f"{PARALLEL}::test_{i}" for i in range(3)]
    collection = misc + parallel + ranked[::-1] + together + [workloads]
    sched = _scheduler()
    log = []
    nodes = [_Node(collection, log) for _ in range(2)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    # the worker given RUN_TOGETHER's two tests takes nothing more yet; the
    # other, holding one test, takes a second
    assert nodes[0].sent == [together]
    assert len(nodes[1].sent) == 2
    while sched.workqueue:
        sched._assign_work_unit(nodes[1])
    # the ranked units first, in the ranking's order; then xdist's order, by
    # test count
    rest = sorted(ranked + [workloads], key=lambda n: schedule.LONGEST_FIRST.index(schedule.work_unit(n)))
    assert log == [together] + [[n] for n in rest] + [misc, parallel]


def test_worker_is_topped_up_at_one_pending_test():
    together = list(schedule.RUN_TOGETHER)
    others = ["tests/test_misc.py::test_0", "tests/test_krylov.py::test_0"]
    collection = together + others
    sched = _scheduler(workers=1)
    node = _Node(collection, [])
    sched.add_node(node)
    sched.add_node_collection(node, collection)
    sched.schedule()
    # xdist's own rule would add a unit at 2 pending tests
    assert node.sent == [together]
    sched.mark_test_complete(node, 0)
    assert node.sent == [together, others[:1]]
    sched.mark_test_complete(node, 1)
    assert node.sent == [together, others[:1], others[1:]]


@pytest.mark.parametrize("dist", ["load", "loadscope", "worksteal", "no"])
def test_other_dists_keep_xdist_scheduler(dist):
    assert schedule.pytest_xdist_make_scheduler(config=_Config(dist), log=None) is None
