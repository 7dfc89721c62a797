"""Shared parser for parameterized registry names (a copy of
``repro.data.naming``) — ``"powerlaw(2.1)"``,
``"rmat(0.57,0.19,0.19,0.05)"``, ``"degree_stratified(0.2,5)"``.

One regex + one float-conversion path for every ``repro_torch`` registry
(sources, splits, partitioners, hot-set scorers), so the accepted grammar
and the error message can never drift between them.
"""
from __future__ import annotations

import re

_PARAM_RE = re.compile(r"^([A-Za-z_][\w+-]*)\(([^()]*)\)$")


def parse_param_name(name: str, kind: str = "registry"
                     ) -> tuple[str, tuple[float, ...]]:
    """Split ``name`` into ``(base, params)``.

    Examples
    --------
    >>> parse_param_name("uniform")
    ('uniform', ())
    >>> parse_param_name("powerlaw(2.1)")
    ('powerlaw', (2.1,))
    >>> parse_param_name("rmat(0.57,0.19,0.19,0.05)")
    ('rmat', (0.57, 0.19, 0.19, 0.05))
    """
    m = _PARAM_RE.match(name)
    if m is None:
        return name, ()
    try:
        params = tuple(float(x) for x in m.group(2).split(",") if x.strip())
    except ValueError:
        raise ValueError(
            f"{kind} parameters in {name!r} must be floats") from None
    return m.group(1), params
