"""String enums (port of ``metrics_tpu/utils/enums.py``).

Case-insensitive ``from_str`` lookup with '-'/'_' normalisation. The legacy
input-type enums (``DataType`` and the averaging enums) come with the checks
that use them.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional


class EnumStr(str, Enum):
    """Base class: case-insensitive string enum."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            return self.value.lower() == other.lower()
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash(self.value.lower())


class ClassificationTask(EnumStr):
    """Task kind used by the task-dispatch façades."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"

    @classmethod
    def from_str_or_raise(cls, value: str) -> "ClassificationTask":
        task = cls.from_str(value)
        if task is None:
            raise ValueError(
                f"Invalid Classification: expected one of ['binary', 'multiclass', 'multilabel'] but got {value}"
            )
        return task  # type: ignore[return-value]
