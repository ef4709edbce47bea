"""Root pytest hooks: when the suite's files start, and where.

``tests/test_map_overfit.py`` holds one test that runs for most of a
parallel run's wall time on its own. pytest-xdist's ``--dist loadfile``
hands out the files with the most tests first, which starts that file last
and makes the run last about its time plus everything before it. So:

- when xdist is loaded, its reorder by test count is turned off (the
  effect of ``--no-loadscope-reorder``, without requiring xdist where it is
  not installed), and files are handed out in collection order;
- collection puts that file's tests first, so that one worker runs it while
  the others share the rest;
- under ``--dist loadfile`` the worker that takes that file is told to
  stop after it, so it starts it at once and takes no other file. xdist
  otherwise gives a worker whose files hold fewer than three pending tests
  one more file at once, and that file would wait behind the long test; a
  worker starts its last pending test only when more arrive or it is told
  to stop;
- the other workers keep the same priority as that worker. Where the
  machine is slow enough that the long test alone nearly fills the time
  limit, it cannot end in time whatever its priority, and the rest of the
  suite, yielding the CPU to it, did not end either; a run that the limit
  cuts counts only the tests that ended.

Nothing is skipped, marked or reordered within a file.
"""

import warnings

import pytest

LONGEST_FIRST = ("tests/test_map_overfit.py",)


def pytest_configure(config):
    if config.pluginmanager.hasplugin("xdist") and hasattr(
            config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(session, config, items):
    def first(item):
        return not item.nodeid.startswith(LONGEST_FIRST)

    items.sort(key=first)  # stable: every other item keeps its place


@pytest.hookimpl(optionalhook=True)  # a hook of xdist, absent without it
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None  # xdist's own scheduler
    from xdist.scheduler import LoadFileScheduling

    # Relies on two private parts of LoadScopeScheduling, as in
    # pytest-xdist 3.8.0: ``_assign_work_unit(node)``, which hands ``node``
    # the first scope of ``workqueue``, an OrderedDict of the pending
    # scopes. Without them, xdist's own scheduler, with a warning.
    class LongestAlone(LoadFileScheduling):
        def _assign_work_unit(self, node):
            scope = next(iter(self.workqueue))
            super()._assign_work_unit(node)
            if scope.startswith(LONGEST_FIRST):
                node.shutdown()  # after this file, and nothing else

    scheduler = LongestAlone(config, log)
    if not (callable(getattr(LoadFileScheduling, "_assign_work_unit", None))
            and isinstance(getattr(scheduler, "workqueue", None), dict)):
        warnings.warn(pytest.PytestWarning(
            "this pytest-xdist has no LoadScopeScheduling._assign_work_unit "
            "or workqueue: tests/test_map_overfit.py is not kept alone on "
            "its worker (written for pytest-xdist 3.8.0)"))
        return None
    return scheduler
