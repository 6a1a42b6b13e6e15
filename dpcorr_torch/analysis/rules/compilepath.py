"""One build path: every kernel build and every capture has one layer.

Counterpart of ``dpcorr.analysis.rules.compilepath`` (the rule id is the
JAX package's). Eager torch lowers nothing, so the port's two "compile"
layers are the places that turn source or Python into something run
later:

- ``ops/_build.py`` builds every ``csrc/*`` source (one ``nvcc`` per
  source, started together; digest-named libraries and their ``ptxas``
  reports; the doctor's build-cache check reads them). A
  ``torch.utils.cpp_extension.load | load_inline`` or an ``nvcc``
  subprocess anywhere else builds a library the cache, the doctor and
  the smoke's ``ptxas`` gate never see.
- ``utils/compile.py`` owns "ahead of time" (``SingleFlight``,
  ``CompileObserver``, the ``dpcorr_compile_*`` series). A
  ``torch.compile(...)`` or a CUDA graph capture (``torch.cuda.graph``,
  ``CUDAGraph().capture_begin``) anywhere else is a program built
  outside that layer: unobserved, undeduplicated.

One rule:

- ``aot-outside-compile-layer`` — any of those outside its layer. An
  ``nvcc`` subprocess is a ``subprocess`` call whose argument list
  starts with ``nvcc_path()`` or a string naming ``nvcc``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.core import (
    Checker,
    Module,
    Violation,
    call_chain,
    imported_names,
    walk_all,
)

_BUILD_LAYER = "ops/_build.py"
_COMPILE_LAYER = "utils/compile.py"

#: dotted origins of in-process extension builds
EXTENSION_BUILDS = frozenset({"torch.utils.cpp_extension.load",
                              "torch.utils.cpp_extension.load_inline"})
#: dotted origins that build a program to run later
CAPTURES = frozenset({"torch.compile", "torch.cuda.graph"})
_SUBPROCESS = frozenset({"subprocess.run", "subprocess.Popen",
                         "subprocess.call", "subprocess.check_call",
                         "subprocess.check_output"})


def _names_nvcc(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "nvcc" in node.value
    if isinstance(node, ast.Call):
        chain = call_chain(node)
        return bool(chain) and chain[-1] == "nvcc_path"
    return False


class CompilePathChecker(Checker):
    name = "compilepath"
    rules = {
        "aot-outside-compile-layer":
            "a kernel build (nvcc, cpp_extension) outside ops/_build.py "
            "or a capture (torch.compile, CUDA graph) outside "
            "utils/compile.py — builds and captures go through their "
            "one layer so they are observed and cached",
    }

    def check(self, module: Module) -> Iterator[Violation]:
        in_build = module.relpath.endswith(_BUILD_LAYER)
        in_compile = module.relpath.endswith(_COMPILE_LAYER)
        imports = imported_names(module.tree)
        for node in walk_all(module.tree):
            if not isinstance(node, ast.Call):
                continue
            what = None
            chain = call_chain(node)
            origin = (".".join((imports.get(chain[0], chain[0]),)
                               + chain[1:]) if chain else "")
            if not in_build:
                if origin in EXTENSION_BUILDS:
                    what = (f"{origin} builds an extension outside "
                            f"{_BUILD_LAYER}")
                elif origin in _SUBPROCESS and node.args and isinstance(
                        node.args[0], (ast.List, ast.Tuple)) and \
                        node.args[0].elts and \
                        _names_nvcc(node.args[0].elts[0]):
                    what = f"an nvcc subprocess outside {_BUILD_LAYER}"
            if not in_compile and what is None:
                if origin in CAPTURES:
                    what = f"{origin} captures outside {_COMPILE_LAYER}"
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "capture_begin":
                    what = f"a CUDA graph capture outside {_COMPILE_LAYER}"
            if what is not None:
                yield Violation(
                    "aot-outside-compile-layer", module.relpath,
                    node.lineno,
                    f"{what} — route it through its layer "
                    f"(ops._build.build_all / utils.compile) so it is "
                    f"observed and cached")
