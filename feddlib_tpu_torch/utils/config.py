"""Typed hierarchical configuration — the Teuchos::ParameterList equivalent.

The reference drives everything from three XML parameter lists merged into one
(problems/tests/laplace/main.cpp:91-97); sublists address solver/preconditioner
knobs (problems/tests/laplace/parametersPrec.xml).  We keep the same logical
keys and the same XML format so reference configs can be reused verbatim.

Teuchos XML format:
    <ParameterList name="...">
      <Parameter name="Overlap" type="int" value="1"/>
      <ParameterList name="CoarseOperator"> ... </ParameterList>
    </ParameterList>
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Iterator, Optional


_TYPE_PARSERS = {
    "int": int,
    "long long int": int,
    "longlong": int,
    "double": float,
    "float": float,
    "string": lambda s: s,
    "bool": lambda s: s.strip().lower() in ("true", "1", "yes"),
}


def _parse_array(type_name: str, value: str):
    # Teuchos array syntax: {1, 2, 3}
    inner = value.strip().lstrip("{").rstrip("}")
    if not inner:
        return []
    elem_t = type_name[len("Array(") : -1].strip()
    parser = _TYPE_PARSERS.get(elem_t, str)
    return [parser(v.strip()) for v in inner.split(",")]


class ParameterList:
    """An ordered, nested string-keyed parameter dictionary.

    Mirrors the subset of Teuchos::ParameterList FEDDLib uses: typed leaf
    parameters, nested sublists, `get(name, default)`, and recursive merge
    (`setParameters`, used when the three config files are combined).
    """

    def __init__(self, name: str = "", items: Optional[dict] = None):
        if isinstance(name, dict):  # ParameterList({...}) convenience form
            name, items = "", name
        self.name = name
        self._items: dict[str, Any] = dict(items or {})

    # -- dict-like access ---------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __getitem__(self, key: str) -> Any:
        return self._items[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._items[key] = value

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def items(self):
        return self._items.items()

    def setdefault(self, key: str, value: Any) -> Any:
        return self._items.setdefault(key, value)

    def keys(self):
        return self._items.keys()

    def get(self, key: str, default: Any = None) -> Any:
        return self._items.get(key, default)

    def sublist(self, key: str, create: bool = True) -> "ParameterList":
        """Nested sublist; created on demand like Teuchos sublist()."""
        val = self._items.get(key)
        if val is None:
            if not create:
                raise KeyError(f"no sublist {key!r} in {self.name!r}")
            val = ParameterList(key)
            self._items[key] = val
        if not isinstance(val, ParameterList):
            raise TypeError(f"parameter {key!r} is a leaf, not a sublist")
        return val

    def set_parameters(self, other: "ParameterList") -> "ParameterList":
        """Recursive merge of `other` into self (other wins), like
        Teuchos::ParameterList::setParameters."""
        for k, v in other.items():
            if isinstance(v, ParameterList):
                mine = self._items.get(k)
                if isinstance(mine, ParameterList):
                    mine.set_parameters(v)
                else:
                    self._items[k] = v.copy()
            else:
                self._items[k] = v
        return self

    def copy(self) -> "ParameterList":
        out = ParameterList(self.name)
        for k, v in self.items():
            out[k] = v.copy() if isinstance(v, ParameterList) else v
        return out

    # -- pretty print -------------------------------------------------------
    def __repr__(self) -> str:
        return f"ParameterList({self.name!r}, {len(self._items)} entries)"

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{self.name or '<root>'}:"]
        for k, v in self.items():
            if isinstance(v, ParameterList):
                lines.append(v.pretty(indent + 1))
            else:
                lines.append(f"{pad}  {k} = {v!r}")
        return "\n".join(lines)

    # -- XML ----------------------------------------------------------------
    @staticmethod
    def from_xml_element(elem: ET.Element) -> "ParameterList":
        plist = ParameterList(elem.get("name", ""))
        for child in elem:
            if child.tag == "ParameterList":
                sub = ParameterList.from_xml_element(child)
                plist[sub.name] = sub
            elif child.tag == "Parameter":
                name = child.get("name")
                type_name = child.get("type", "string")
                raw = child.get("value", "")
                if type_name.startswith("Array("):
                    plist[name] = _parse_array(type_name, raw)
                else:
                    parser = _TYPE_PARSERS.get(type_name, str)
                    plist[name] = parser(raw)
        return plist

    def to_xml_element(self) -> ET.Element:
        elem = ET.Element("ParameterList", {"name": self.name})
        for k, v in self.items():
            if isinstance(v, ParameterList):
                elem.append(v.to_xml_element())
            else:
                if isinstance(v, bool):
                    t, s = "bool", "true" if v else "false"
                elif isinstance(v, int):
                    t, s = "int", str(v)
                elif isinstance(v, float):
                    t, s = "double", repr(v)
                elif isinstance(v, list):
                    if v and isinstance(v[0], int):
                        et = "int"
                    elif v and isinstance(v[0], float):
                        et = "double"
                    else:
                        et = "string"
                    t = f"Array({et})"
                    s = "{" + ",".join(str(x) for x in v) + "}"
                else:
                    t, s = "string", str(v)
                ET.SubElement(
                    elem, "Parameter", {"name": k, "type": t, "value": s}
                )
        return elem

    def write_xml(self, path: str) -> None:
        tree = ET.ElementTree(self.to_xml_element())
        ET.indent(tree)
        tree.write(path, xml_declaration=True, encoding="unicode")


def load_xml_parameters(path: str) -> ParameterList:
    """Load a Teuchos-format XML parameter file (reference-compatible)."""
    root = ET.parse(path).getroot()
    if root.tag != "ParameterList":
        raise ValueError(f"{path}: expected root <ParameterList>, got <{root.tag}>")
    return ParameterList.from_xml_element(root)


def merge_parameter_files(*paths: str) -> ParameterList:
    """Merge several parameter files into one list (later files win), like the
    reference's main() merging problem/prec/solver files
    (problems/tests/laplace/main.cpp:91-97)."""
    out = ParameterList("Parameters")
    for p in paths:
        out.set_parameters(load_xml_parameters(p))
    return out
