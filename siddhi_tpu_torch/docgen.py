"""Extension documentation generator.

Re-design of the reference ``modules/siddhi-doc-gen`` (Maven mojo +
Freemarker templates rendering @Extension metadata to markdown/mkdocs):
here extension metadata is the registered class itself — kind, name,
namespace, constructor signature, and docstring — rendered to markdown.
Port of the JAX package's ``docgen.py`` over the port's registry, which
holds every kind the port plans, sources, sinks and their mappers
included.

CLI: ``python -m siddhi_tpu_torch.docgen [output.md]``
"""

from __future__ import annotations

import inspect
import sys

from siddhi_tpu_torch.extension.registry import KINDS, default_registry


_KIND_TITLES = {
    "window": "Windows (`#window.name(...)`)",
    "function": "Scalar functions",
    "aggregator": "Attribute aggregators",
    "stream_processor": "Stream processors",
    "stream_function": "Stream functions",
    "source": "Sources (`@source(type='...')`)",
    "sink": "Sinks (`@sink(type='...')`)",
    "source_mapper": "Source mappers (`@map(type='...')`)",
    "sink_mapper": "Sink mappers (`@map(type='...')`)",
    "table": "Tables",
    "store": "Stores (`@store(type='...')`)",
    "script": "Script languages (`define function f[lang]`)",
}


def _doc_of(factory) -> str:
    doc = inspect.getdoc(factory) or "(undocumented)"
    return doc.strip()


def generate_markdown(registry=None, title: str = "siddhi_tpu extensions") -> str:
    """Markdown API reference for every registered extension."""
    reg = registry if registry is not None else default_registry()
    lines = [f"# {title}", ""]
    lines.append(
        "Auto-generated from extension registrations (the reference "
        "generates the analogous pages from `@Extension` annotations via "
        "siddhi-doc-gen)."
    )
    lines.append("")
    for kind in KINDS:
        items = reg.items(kind)
        if not items:
            continue
        lines.append(f"## {_KIND_TITLES.get(kind, kind)}")
        lines.append("")
        for full_name, factory in sorted(items):
            lines.append(f"### `{full_name}`")
            lines.append("")
            lines.append(_doc_of(factory))
            lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    md = generate_markdown()
    if argv:
        with open(argv[0], "w") as f:
            f.write(md)
    else:
        print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
