"""Drift guard for the modules the port copies from the JAX package.

The port imports nothing of ``archi_tpu`` (``tests/test_torch_guard.py``),
so the data-manager service's framework-free modules live in the port as
copies.  Each copy must stay the JAX package's source with the import prefix
renamed (``archi_tpu.`` → ``archi_tpu_torch.``) and one line added to its
docstring that names the original.  The modules over the store are copies
too, with the store's class renamed as well; only their docstrings are
their own.  A change to either side fails here until the other follows.
"""

import ast
import difflib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: what the port renames in a copied module
RENAMES = (("archi_tpu.", "archi_tpu_torch."),
           ("TpuVectorStore", "TorchVectorStore"))


def _jax_source(rel: str) -> str:
    """The JAX package's module as the port would copy it."""
    text = (ROOT / "archi_tpu" / rel).read_text()
    for old, new in RENAMES:
        text = text.replace(old, new)
    return text


def _after_docstring(text: str) -> str:
    """A module's source after its module docstring."""
    doc = ast.parse(text).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return "".join(text.splitlines(keepends=True)[doc.end_lineno:])


COPIES = (
    "config/defaults.py", "config/manager.py", "config/service.py",
    "utils/app_db.py", "utils/logging_utils.py", "utils/documents.py",
    "utils/stemmer.py",
    "data/catalog.py", "data/chunking.py", "data/loaders.py",
    "data/persistence.py", "data/resource.py", "data/scheduler.py",
    "data/collectors/local_files.py", "data/collectors/scraper.py",
    "data/collectors/git_scraper.py", "data/collectors/tickets.py",
    "data/collectors/anonymizer.py",
    "pipelines/agents/tools/base.py",
    "pipelines/agents/tools/catalog_tools.py",
    "web/framework.py", "web/data_app.py",
)

#: copies over the port's store: the code after the docstring is the JAX
#: package's, renamed; the docstring names the original and speaks of the
#: card, not of the TPU
STORE_COPIES = ("data/manager.py", "data/data_manager.py")

#: counterparts that differ from the JAX package's module, and why
DEPARTURES = {
    "data/data_viewer.py": "names the index dtype as the JAX package does "
                           "('bfloat16', not 'torch.bfloat16'); otherwise a "
                           "store copy (test_data_viewer_departs_by_the_"
                           "dtype_name_only)",
    "bin/service_data_manager.py": "builds the port's context (device=, "
                                   "devices=) and logs a checkpoint that "
                                   "was not written",
    "bin/bootstrap.py": "builds the data-manager's fields only, on the "
                        "port's store; a Postgres app_db raises",
    "utils/hardware.py": "resolves CUDA devices (the JAX module's on_tpu)",
    "utils/metrics.py": "adds use_registry (METRICS forwards to the "
                        "registry in use)",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_module(rel):
    want = _jax_source(rel)
    got = (ROOT / "archi_tpu_torch" / rel).read_text()
    note = f"Copy of ``archi_tpu/{rel}``.\n\n"
    assert got.count(note) == 1, f"{rel}: the docstring does not name it"
    assert got.replace(note, "", 1) == want, \
        f"archi_tpu_torch/{rel} drifted from archi_tpu/{rel}"


@pytest.mark.parametrize("rel", sorted(DEPARTURES))
def test_departures_are_not_copies(rel):
    """A module listed as departing must really differ, so that a module
    brought back in line moves to ``COPIES`` and is guarded again."""
    assert (ROOT / "archi_tpu_torch" / rel).read_text() != _jax_source(rel)


@pytest.mark.parametrize("rel", STORE_COPIES)
def test_store_copy_equals_the_jax_module(rel):
    got = (ROOT / "archi_tpu_torch" / rel).read_text()
    assert f"Counterpart of ``archi_tpu/{rel}``" in ast.get_docstring(
        ast.parse(got)), f"{rel}: the docstring does not name it"
    assert _after_docstring(got) == _after_docstring(_jax_source(rel)), \
        f"archi_tpu_torch/{rel} drifted from archi_tpu/{rel}"


def test_data_viewer_departs_by_the_dtype_name_only():
    rel = "data/data_viewer.py"
    got = _after_docstring((ROOT / "archi_tpu_torch" / rel).read_text())
    want = _after_docstring(_jax_source(rel))
    changed = [line for line in difflib.ndiff(want.splitlines(),
                                              got.splitlines())
               if line[:2] in ("- ", "+ ")]
    assert changed == [
        '+             # the dtype\'s name as the JAX package reports it '
        '("bfloat16",',
        '+             # not "torch.bfloat16")',
        '-             "index_dtype": str(self.vectorstore.index.dtype),',
        '+             "index_dtype": str(self.vectorstore.index.dtype)'
        '.removeprefix(',
        '+                 "torch."),',
    ]


def test_every_module_with_a_jax_namesake_is_listed():
    """Each port module of the service layers is a guarded copy or a listed
    departure (the engine, models, ops and native layers are ports held by
    their parity tests)."""
    layers = ("config", "data", "pipelines", "web", "utils", "bin")
    port = ROOT / "archi_tpu_torch"
    unlisted = []
    for path in sorted(port.rglob("*.py")):
        rel = str(path.relative_to(port))
        if rel.split("/")[0] not in layers or path.name == "__init__.py":
            continue
        if (ROOT / "archi_tpu" / rel).exists() and rel not in COPIES \
                and rel not in STORE_COPIES and rel not in DEPARTURES:
            unlisted.append(rel)
    assert not unlisted
