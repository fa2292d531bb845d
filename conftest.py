"""Keep the `xl` soaks out of every run whose `-m` does not name them.

`pytest.ini`'s addopts hold `-m "not xl"`, but pytest keeps only the last
`-m` it is given, so a command with its own (tier 1's `-m 'not slow'`, or
`-m slow`) would collect the soaks again: a 2^14 AHP with a 3600 s limit and
tens of GB, and Pallas kernels that take minutes each in interpret mode.
This hook deselects them unless the run's marker expression mentions `xl`,
so `-m xl` still runs all of them and `-m 'slow or xl'` runs them beside the
slow tier.
"""

import re


def _names_xl(markexpr: str) -> bool:
    return re.search(r"\bxl\b", markexpr or "") is not None


def pytest_collection_modifyitems(config, items):
    if _names_xl(config.getoption("markexpr", "")):
        return
    xl = [item for item in items if item.get_closest_marker("xl") is not None]
    if xl:
        config.hook.pytest_deselected(items=xl)
        items[:] = [item for item in items if item.get_closest_marker("xl") is None]
