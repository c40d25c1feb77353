"""Runtime Environment (RE) specification — PhoenixCloud §4.2.

The paper expresses RE requirements as an XML document (Fig. 3). Here the
specification is a typed dataclass with the same fields plus the
TPU-adaptation fields (chip granularity, arch payload). ``to_xml`` emits a
document shaped like the paper's Fig. 3 so specs remain interchangeable
with the original format.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional
from xml.etree import ElementTree as ET


class Relationship(enum.Enum):
    """Provider relationship (§4.2 item 1)."""

    SAME = "same"          # one party is both resource + service provider (DCS)
    AFFILIATED = "affiliated"  # Case Three: private cloud inside one org
    BUSINESS = "business"  # Case One/Two: public cloud tenancy


class WorkloadType(enum.Enum):
    """Workload families (§4.2 item 2).

    The paper supports parallel batch jobs and Web services. On the TPU
    cluster these are training jobs and serving replicas respectively; the
    original names are kept as aliases so the reproduction reads like the
    paper.
    """

    PARALLEL_BATCH_JOBS = "parallel_batch_jobs"   # == training jobs
    WEB_SERVICE = "web_service"                   # == inference serving

    # Modern aliases.
    TRAINING = "parallel_batch_jobs"
    SERVING = "web_service"


class Granularity(enum.Enum):
    """Allocation granularity (§4.2 item 3)."""

    NODE = "node"
    VIRTUAL_MACHINE = "virtual_machine"
    CHIP_SLICE = "chip_slice"   # TPU adaptation: contiguous mesh slice


class CoordinationModel(enum.Enum):
    """Resource coordination models (§4.2 item 5)."""

    NONE = "none"          # independent provisioning (RightScale-style)
    FB = "FB"              # Fixed Bound — private cloud
    FLB_NUB = "FLB_NUB"    # Fixed Lower Bound / No Upper Bound — public cloud


class SetupPolicy(enum.Enum):
    """Setup work on provision/release (§4.2 item 6)."""

    NONE = "NO"            # hand nodes over as-is
    WIPE = "WIPE"          # scrub state (OS/data in the paper; HBM here)
    RELOAD = "RELOAD"      # TPU adaptation: reload weights onto the slice


@dataclasses.dataclass(frozen=True)
class ResourceBounds:
    """Lower (rigid) and upper (flexible) resource bounds (§4.2, Fig. 2).

    ``lower`` is guaranteed to the RE (or its coordinated partner).
    ``upper`` may be ``None`` — the FLB-NUB model leaves it undefined.
    """

    lower: int
    upper: Optional[int] = None

    def __post_init__(self) -> None:
        if self.lower < 0:
            raise ValueError(f"lower bound must be >= 0, got {self.lower}")
        if self.upper is not None and self.upper < self.lower:
            raise ValueError(
                f"upper bound {self.upper} < lower bound {self.lower}")


@dataclasses.dataclass(frozen=True)
class RuntimeEnvironmentSpec:
    """A complete RE specification (paper Fig. 3 + TPU fields)."""

    name: str
    relationship: Relationship
    workload: WorkloadType
    granularity: Granularity
    coordination: CoordinationModel
    bounds: ResourceBounds
    setup_policy: SetupPolicy = SetupPolicy.NONE
    # Consent bits (§4.2 item 4).
    wants_coordinated_partner: bool = True      # (a) partner from same provider
    allows_foreign_coordination: bool = True    # (b) share with other providers
    # TPU adaptation: which architecture config this RE's payload runs.
    arch: Optional[str] = None

    def validate(self) -> None:
        if self.coordination is CoordinationModel.FB:
            if self.bounds.upper is None or self.bounds.upper != self.bounds.lower:
                raise ValueError(
                    "FB model requires upper == lower (paper §5.1 rule 1)")
        if self.coordination is CoordinationModel.FLB_NUB:
            if self.bounds.upper is not None:
                raise ValueError(
                    "FLB-NUB model requires an undefined upper bound (§5.2 rule 1)")

    def to_xml(self) -> str:
        root = ET.Element("runtime_environment_agreement", name=self.name)
        ET.SubElement(root, "relationship", type=self.relationship.value)
        ET.SubElement(root, "workload", type=self.workload.value)
        env = ET.SubElement(
            root,
            "environment",
            type="coordinated" if self.coordination is not CoordinationModel.NONE
            else "independent",
            granularity=self.granularity.value,
            resource_coordination_mode=self.coordination.value,
            lower_bound_size=str(self.bounds.lower),
            upper_bound_size="null" if self.bounds.upper is None
            else str(self.bounds.upper),
            setup_policy=self.setup_policy.value,
        )
        if self.arch is not None:
            env.set("arch", self.arch)
        return ET.tostring(root, encoding="unicode")

    @staticmethod
    def from_xml(text: str) -> "RuntimeEnvironmentSpec":
        root = ET.fromstring(text)
        env = root.find("environment")
        assert env is not None
        upper = env.get("upper_bound_size")
        rel = root.find("relationship")
        wl = root.find("workload")
        assert rel is not None and wl is not None
        spec = RuntimeEnvironmentSpec(
            name=root.get("name", ""),
            relationship=Relationship(rel.get("type", "").strip()),
            workload=WorkloadType(wl.get("type", "").strip()),
            granularity=Granularity(env.get("granularity", "node").strip()),
            coordination=CoordinationModel(
                env.get("resource_coordination_mode", "none")),
            bounds=ResourceBounds(
                lower=int(env.get("lower_bound_size", "0")),
                upper=None if upper in (None, "null") else int(upper),
            ),
            setup_policy=SetupPolicy(env.get("setup_policy", "NO")),
            arch=env.get("arch"),
        )
        return spec


def paper_fig3_example() -> RuntimeEnvironmentSpec:
    """The example specification from the paper's Fig. 3."""
    return RuntimeEnvironmentSpec(
        name="user1",
        relationship=Relationship.BUSINESS,
        workload=WorkloadType.PARALLEL_BATCH_JOBS,
        granularity=Granularity.NODE,
        coordination=CoordinationModel.FLB_NUB,
        bounds=ResourceBounds(lower=100, upper=None),
        setup_policy=SetupPolicy.NONE,
    )
