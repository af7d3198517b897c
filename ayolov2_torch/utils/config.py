"""Config files: data and model configs as dicts.

The counterpart of ``load_yaml`` in ``ayolov2_tpu/utils/config.py``. A file
that holds JSON is read with ``json`` (JSON is a subset of YAML, so the
result is what ``yaml.safe_load`` gives); anything else needs PyYAML, which
is imported only then.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Union


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    text = Path(path).read_text(encoding="utf-8")
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs PyYAML (the package 'yaml'), which is not installed; "
            "write the config as JSON instead") from e
    return yaml.safe_load(text)
