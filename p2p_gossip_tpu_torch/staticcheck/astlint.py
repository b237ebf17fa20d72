"""AST lint: seed discipline, host reads in tick bodies, the copy rule.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/astlint.py``
(L1-L4). Pure ``ast`` over the port's package and ``chip_smoke.py``; the
tests are out of scope (they pin seeds on purpose), as is
``staticcheck/fixtures.py`` (bad on purpose). Rules:

  L0  copy-rule          no ``import jax`` and no import of the JAX package
                         (``p2p_gossip_tpu``, not ``p2p_gossip_tpu_torch``):
                         the port keeps its own copies
  L1' random-generator   every random draw names its generator: no
                         ``torch.manual_seed``, no ``torch.rand*`` /
                         ``randint`` / ``randperm`` / ``bernoulli`` /
                         ``multinomial`` / ``normal`` (nor a tensor's
                         ``uniform_`` / ``normal_`` / ``random_`` /
                         ``bernoulli_``) without ``generator=``, no
                         ``np.random.seed`` and no module-level
                         ``np.random.<sampler>``. Stateful generators are
                         meant to be reused, so JAX's key-reuse rule does
                         not carry over; its aim does: streams that neither
                         collide nor correlate
  L2  seed-offset-literal the seed offsets 104729 / 7919 only in
                         ``models/seeds.py`` (the values are imported from
                         there, so this lint keeps no copy)
  L3' tick-host-read     host reads in the code a registered entry runs once
                         a tick or round (its ``tick_bodies``) at most the
                         entry's ``host_reads_per_tick``: ``.item()``,
                         ``.tolist()``, ``.cpu()``, ``.numpy()``,
                         ``torch.tensor`` / ``as_tensor`` with ``device=``,
                         and ``bool`` / ``int`` / ``float`` of, or an
                         ``if`` / ``while`` on, a tensor. With no jit this
                         takes the place of L3 and L4: a host read in the
                         tick is the port's tracer branch

"A tensor" for L3' is a name bound in the function from a call that is
not a host builtin (``_, nonzero = _tick(...)``), or a call of a tensor
reduction (``x.any()``, ``x.sum()``, ...); a value read from the host
(``host[0] > 0`` after ``host = vec.tolist()``) or a Python container's
item is not one, and ``is None``, membership and string compares are
structure tests. No suppression syntax: a false positive is fixed in the
rule or in the entry's registration, with the reason in a comment.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from p2p_gossip_tpu_torch.models.seeds import CHURN_SEED_OFFSET, LOSS_SEED_OFFSET

PACKAGE = "p2p_gossip_tpu_torch"
SEEDS_MODULE = os.path.join(PACKAGE, "models", "seeds.py")
SEED_OFFSET_LITERALS = {LOSS_SEED_OFFSET, CHURN_SEED_OFFSET}
EXCLUDE = (os.path.join(PACKAGE, "staticcheck", "fixtures.py"),)

TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
                  "normal", "rand_like", "randn_like", "randint_like", "poisson"}
TENSOR_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                   "geometric_", "cauchy_", "log_normal_"}
#: ``np.random`` attributes that are not the module-level global stream.
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "PCG64DXSM",
                "Philox", "SFC64", "MT19937", "BitGenerator", "RandomState"}
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_BUILTINS = {"len", "range", "int", "bool", "float", "sum", "any", "all", "min", "max",
                 "list", "tuple", "set", "dict", "sorted", "isinstance", "enumerate", "zip",
                 "abs", "round", "divmod", "str", "repr", "getattr", "hasattr", "id"}
TENSOR_REDUCTIONS = {"any", "all", "sum", "max", "min", "item", "count_nonzero"}


@dataclasses.dataclass
class LintViolation:
    file: str
    line: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _chain(node) -> list[str]:
    """['torch', 'rand'] for torch.rand; [] if not a name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


class _FileLinter:
    def __init__(self, rel: str, tree: ast.Module):
        self.rel, self.tree = rel, tree
        self.violations: list[LintViolation] = []

    def flag(self, node, rule: str, message: str) -> None:
        self.violations.append(LintViolation(self.rel, getattr(node, "lineno", 0), rule,
                                             message))

    def lint_imports(self) -> None:  # L0
        for node in ast.walk(self.tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "p2p_gossip_tpu"):
                    self.flag(node, "L0-copy-rule",
                              f"import of {name}: the port imports nothing of JAX or of the "
                              "JAX package (it keeps its own copies)")

    def lint_seed_literals(self) -> None:  # L2
        if self.rel.replace("/", os.sep).endswith(SEEDS_MODULE):
            return
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, int)
                    and not isinstance(node.value, bool)
                    and node.value in SEED_OFFSET_LITERALS):
                self.flag(node, "L2-seed-offset-literal",
                          f"hardcoded seed offset {node.value} shadows the stream-"
                          "derivation contract: use p2p_gossip_tpu_torch.models.seeds")

    def lint_random(self) -> None:  # L1'
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            if chain[:1] == ["torch"] and chain[1:] == ["manual_seed"]:
                self.flag(node, "L1-random-generator",
                          "torch.manual_seed seeds the global stream: pass a "
                          "torch.Generator to each draw")
            elif (chain[:1] == ["torch"] and len(chain) == 2 and chain[1] in TORCH_SAMPLERS
                  and not _has_kw(node, "generator")):
                self.flag(node, "L1-random-generator",
                          f"torch.{chain[1]} without generator= draws from the global "
                          "stream")
            elif (isinstance(node.func, ast.Attribute) and node.func.attr in TENSOR_SAMPLERS
                  and not _has_kw(node, "generator")):
                self.flag(node, "L1-random-generator",
                          f".{node.func.attr}() without generator= draws from the global "
                          "stream")
            elif (len(chain) == 3 and chain[0] in ("np", "numpy") and chain[1] == "random"
                  and chain[2] not in NP_RANDOM_OK):
                self.flag(node, "L1-random-generator",
                          f"np.random.{chain[2]} uses numpy's global stream: draw from "
                          "np.random.default_rng(seed)")


def _suspect(expr, tensors: set) -> bool:
    """Whether ``expr`` may be a tensor (the L3' typing, module doc)."""
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.UnaryOp):
        return _suspect(expr.operand, tensors)
    if isinstance(expr, ast.Compare) and (
            all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops)
            or any(isinstance(x, ast.Constant) and isinstance(x.value, str)
                   for x in (expr.left, *expr.comparators))):
        return False  # a structure test, a membership test or a string compare
    if isinstance(expr, (ast.Compare, ast.BinOp, ast.BoolOp)):
        parts = ([expr.left, *expr.comparators] if isinstance(expr, ast.Compare)
                 else [expr.left, expr.right] if isinstance(expr, ast.BinOp) else expr.values)
        return any(_suspect(p, tensors) for p in parts)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        return expr.func.attr in TENSOR_REDUCTIONS and not _host_call(expr)
    return False


def _host_call(call: ast.Call) -> bool:
    chain = _chain(call.func)
    return (isinstance(call.func, ast.Name) and call.func.id in HOST_BUILTINS) or (
        chain[:1] in (["np"], ["numpy"], ["math"]))


class _TickBody(ast.NodeVisitor):
    """Host-read sites in one tick body, in statement order."""

    def __init__(self):
        self.tensors: set = set()
        self.sites: list = []

    def _bind(self, targets, value) -> None:
        tensor = isinstance(value, ast.Call) and not _host_call(value) and not (
            isinstance(value.func, ast.Attribute) and value.func.attr in HOST_READ_METHODS)
        for tgt in targets:
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    (self.tensors.add if tensor else self.tensors.discard)(n.id)

    def visit_Assign(self, node):
        self.generic_visit(node)
        self._bind(node.targets, node.value)

    def visit_AnnAssign(self, node):
        self.generic_visit(node)
        if node.value is not None:
            self._bind([node.target], node.value)

    def visit_Call(self, node):
        chain = _chain(node.func)
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_READ_METHODS \
                and not node.args and chain[:1] not in (["np"], ["numpy"]):
            self.sites.append((node.lineno, f".{node.func.attr}()"))
        elif chain in (["torch", "tensor"], ["torch", "as_tensor"]) and _has_kw(node, "device"):
            self.sites.append((node.lineno, f"{'.'.join(chain)}(..., device=)"))
        elif (isinstance(node.func, ast.Name) and node.func.id in ("bool", "int", "float")
              and node.args and _suspect(node.args[0], self.tensors)):
            self.sites.append((node.lineno, f"{node.func.id}(<tensor>)"))
        self.generic_visit(node)

    def _test(self, node):
        if _suspect(node.test, self.tensors):
            self.sites.append((node.lineno, "a branch on a tensor"))
        self.generic_visit(node)

    visit_If = visit_While = visit_IfExp = _test


def _find(tree: ast.Module, qualname: str):
    """The function ``Class.method`` or ``function`` of a module."""
    scope = tree.body
    node = None
    for part in qualname.split("."):
        node = next((n for n in scope if isinstance(n, (ast.FunctionDef, ast.ClassDef,
                                                        ast.AsyncFunctionDef))
                     and n.name == part), None)
        if node is None:
            return None
        scope = node.body
    return node


def tick_body_sites(repo_root: str, body: str, trees: dict) -> list | None:
    """Host-read sites (line, what) of one ``"path:qualname[loop]"`` tick
    body; None when the function is missing."""
    path, _, qual = body.partition(":")
    loop = qual.endswith("[loop]")
    qual = qual.removesuffix("[loop]")
    if path not in trees:
        with open(os.path.join(repo_root, path), encoding="utf-8") as f:
            trees[path] = ast.parse(f.read(), filename=path)
    fn = _find(trees[path], qual)
    if fn is None:
        return None
    visitor = _TickBody()
    for stmt in fn.body:
        if loop and isinstance(stmt, (ast.While, ast.For)):
            visitor.sites = []  # the statements before it only type its names
            visitor.visit(stmt)
            return visitor.sites
        visitor.visit(stmt)
    if loop:
        return None
    return visitor.sites


def lint_tick_bodies(repo_root: str, entries) -> tuple[list, dict]:
    """L3' over every registered entry's tick bodies. Returns (violations,
    {entry: host-read sites})."""
    trees: dict = {}
    violations, per_entry = [], {}
    for entry in entries:
        sites = []
        for body in entry.tick_bodies:
            found = tick_body_sites(repo_root, body, trees)
            path = body.partition(":")[0]
            if found is None:
                violations.append(LintViolation(path, 0, "L3-tick-host-read",
                                                f"{entry.name}: tick body {body} not found"))
                continue
            sites += [(path, line, what) for line, what in found]
        per_entry[entry.name] = len(sites)
        if len(sites) > entry.host_reads_per_tick:
            where = "; ".join(f"{p}:{ln} {w}" for p, ln, w in sites)
            violations.append(LintViolation(
                sites[0][0], sites[0][1], "L3-tick-host-read",
                f"{entry.name}: {len(sites)} host-read sites in its tick bodies, declared "
                f"{entry.host_reads_per_tick} a tick ({where})"))
    return violations, per_entry


def _scan_roots(repo_root: str) -> list[str]:
    roots = []
    for dirpath, _dirs, files in os.walk(os.path.join(repo_root, PACKAGE)):
        roots += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    smoke = os.path.join(repo_root, "chip_smoke.py")
    if os.path.exists(smoke):
        roots.append(smoke)
    return sorted(roots)


def lint_source(src: str, rel: str) -> list[LintViolation]:
    """L0, L1' and L2 on one file's source."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [LintViolation(rel, e.lineno or 0, "syntax-error", str(e))]
    linter = _FileLinter(rel, tree)
    linter.lint_imports()
    linter.lint_random()
    linter.lint_seed_literals()
    return linter.violations


def default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_lint(repo_root: str | None = None, entries=None) -> dict:
    """Lint the port; JSON-ready {"ok", "files_scanned", "tick_sites",
    "violations"}."""
    repo_root = repo_root or default_root()
    violations: list[LintViolation] = []
    scanned = 0
    for path in _scan_roots(repo_root):
        rel = os.path.relpath(path, repo_root)
        if rel in EXCLUDE:
            continue
        scanned += 1
        with open(path, encoding="utf-8") as f:
            violations += lint_source(f.read(), rel)
    if entries is None:
        from p2p_gossip_tpu_torch.staticcheck import entrypoints, registry

        entrypoints.load_all()
        entries = registry.all_entries()
    tick, per_entry = lint_tick_bodies(repo_root, entries)
    violations += tick
    return {"ok": not violations, "files_scanned": scanned, "tick_sites": per_entry,
            "violations": [v.as_dict() for v in violations]}
