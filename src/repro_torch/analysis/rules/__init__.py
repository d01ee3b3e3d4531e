"""Rule registry for the port's linter (the JAX package's seven codes, in
its order, each reading the port's own form of the hazard).

Each rule is a class with ``CODE`` / ``TITLE`` / ``DOC`` and a
``check(ctx: FileContext) -> Iterator[Violation]`` method.  Rules are pure
stdlib-``ast`` visitors — no torch imports — so the linter runs anywhere.
"""
from __future__ import annotations

from repro_torch.analysis.rules.dist_rules import Dist001, Dist002
from repro_torch.analysis.rules.hash_rules import Hash001
from repro_torch.analysis.rules.jit_rules import Jit001
from repro_torch.analysis.rules.obs_rules import Obs001
from repro_torch.analysis.rules.prec_rules import Prec001
from repro_torch.analysis.rules.sync_rules import Sync001

ALL_RULES = (Dist001(), Dist002(), Sync001(), Jit001(), Hash001(),
             Prec001(), Obs001())

RULES_BY_CODE = {r.CODE: r for r in ALL_RULES}
