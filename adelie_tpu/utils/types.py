"""Central option/enum layer (reference adelie_core/util/types.hpp:12-100).

The reference defines C++ enums (``util::screen_rule_type``,
``util::tie_method_type``, ...) plus ``convert_*`` helpers that translate
user-facing strings once, at the API boundary, and raise on anything
unknown.  The device-first equivalent keeps the *strings* (they are static,
trace-time configuration — nothing device-side ever branches on them) but
centralizes the vocabulary and the validation here, so a typo'd
``screen_rule`` fails at ``grpnet(...)`` entry with the full list of valid
options instead of deep inside a BASIL screen pass.

Every public entry point taking a string knob calls the matching
``Option`` below; downstream code may then compare against the canonical
strings without re-validating.
"""

from __future__ import annotations

__all__ = [
    "Option",
    "screen_rule",
    "tie_method",
    "css_method",
    "css_loss",
    "bcd_solver",
    "newton_method",
    "constraint_method",
    "read_mode",
    "matrix_method",
    "binomial_link",
    "multi_intercept_kind",
]


class Option:
    """A named, closed set of string options.

    Calling the option validates (and canonicalizes) a value::

        rule = types.screen_rule(user_value)     # -> canonical str
        types.screen_rule("pivto")               # -> ValueError listing options

    ``aliases`` maps accepted spellings onto canonical values (e.g. the
    ``auto`` read mode resolving to ``mmap``).
    """

    def __init__(self, name, values, aliases=None):
        self.name = str(name)
        self.values = tuple(values)
        self._aliases = dict(aliases or {})
        self._set = frozenset(self.values) | frozenset(self._aliases)

    def __call__(self, value, *, param=None, canonical=True):
        param = param or self.name
        if not isinstance(value, str) or value not in self._set:
            raise ValueError(
                f"{param} must be one of {sorted(self._set)}, got {value!r}"
            )
        if canonical:
            return self._aliases.get(value, value)
        return value

    def __contains__(self, value):
        return value in self._set

    def __iter__(self):
        return iter(self.values)

    def __repr__(self):
        return f"Option({self.name!r}, {list(self.values)!r})"


# --- solver knobs (reference util/types.hpp screen_rule_type) ---
screen_rule = Option("screen_rule", ("strong", "pivot"))

# --- cox ties (reference util/types.hpp tie_method_type) ---
tie_method = Option("tie_method", ("efron", "breslow"))

# --- column subset selection (reference solver.py:1274 css_cov) ---
css_method = Option("method", ("greedy", "swapping"))
css_loss = Option("loss", ("least_squares", "subset_factor", "min_det"))

# --- BCD root strategies (reference bcd.py:40-49) ---
newton_method = Option(
    "method", ("newton", "newton_abs", "newton_brent", "brent")
)
bcd_solver = Option(
    "solver",
    ("newton", "newton_abs", "newton_brent", "brent",
     "ista", "fista", "fista_adares"),
)

# --- constraint inner solver (reference constraint/*.hpp) ---
constraint_method = Option("method", ("proximal_newton", "admm"))

# --- SNP IO read mode (reference io/io_snp_base.hpp read_mode_type) ---
read_mode = Option("read_mode", ("file", "mmap"), aliases={"auto": "mmap"})

# --- matrix factory dispatch (reference matrix.py factories) ---
matrix_method = Option("method", ("naive", "cov", "constraint"))

# --- binomial link (reference glm.py:83-199) ---
binomial_link = Option("link", ("logit", "probit"))

# --- multi-response intercept handling (reference glm.py multi) ---
multi_intercept_kind = Option("kind", ("grouped", "ungrouped"))
