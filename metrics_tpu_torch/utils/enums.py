"""String enums (port of ``metrics_tpu/utils/enums.py``).

Case-insensitive ``from_str`` lookup with '-'/'_' normalisation.
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


class DataType(EnumStr):
    """Classification input type (decided by the legacy formatter)."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = None  # type: ignore[assignment]
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTaskNoMultilabel(EnumStr):
    """Tasks for metrics without a multilabel variant (calibration, hinge)."""

    BINARY = "binary"
    MULTICLASS = "multiclass"

    @classmethod
    def from_str_or_raise(cls, value: str) -> "ClassificationTaskNoMultilabel":
        task = cls.from_str(value)
        if task is None:
            raise ValueError(
                f"Invalid Classification: expected one of ['binary', 'multiclass'] but got {value}"
            )
        return task  # type: ignore[return-value]
