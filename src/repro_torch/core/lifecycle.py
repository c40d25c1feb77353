"""Lifecycle Management Service — TRE states and creation flow (§4.3).

A TRE moves through ``uninitialized → created → running`` (and back via
``deactivate``/``destroy``). The flow follows the paper's nine-step
lifecycle: spec registration, deployment (here: building the payload —
model/optimizer/serving engine factories), configuration hand-off to the
Resource Provision Service, component start, and initial provisioning of
the lower bound.

The CSF ("common service framework") is the collection of services the
resource provider runs: this lifecycle service, a provision service
(``core.provision``), and — in the live system — the deployment hooks
that build JAX payloads (``runtime_bridge``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional

from repro_torch.core.spec import (CoordinationModel, RuntimeEnvironmentSpec,
                             WorkloadType)


class TREState(enum.Enum):
    UNINITIALIZED = "uninitialized"
    CREATED = "created"
    RUNNING = "running"
    DEACTIVATED = "deactivated"


@dataclasses.dataclass
class TRE:
    """A thin runtime environment: Manager + Scheduler + payload."""

    spec: RuntimeEnvironmentSpec
    state: TREState = TREState.UNINITIALIZED
    manager: Optional[object] = None     # PBJManager or WSManager
    payload: Optional[object] = None     # deployed JAX payload (bridge)
    partner: Optional[str] = None        # coordinated partner TRE name


class LifecycleManagementService:
    """Creates coordinated TREs on demand from RE specifications."""

    def __init__(self) -> None:
        self._tres: Dict[str, TRE] = {}
        self._deployers: Dict[WorkloadType, Callable[[RuntimeEnvironmentSpec], object]] = {}

    def register_deployer(self, workload: WorkloadType,
                          deploy: Callable[[RuntimeEnvironmentSpec], object]) -> None:
        """CSF Deployment Service hook: builds the workload payload."""
        self._deployers[workload] = deploy

    def tre(self, name: str) -> TRE:
        return self._tres[name]

    # ------------------------------------------------------- lifecycle steps

    def create(self, spec: RuntimeEnvironmentSpec) -> TRE:
        """Steps 2–3: register the spec, deploy the TRE software."""
        spec.validate()
        if spec.name in self._tres:
            raise ValueError(f"TRE {spec.name!r} already exists")
        tre = TRE(spec=spec)
        self._tres[spec.name] = tre
        deployer = self._deployers.get(spec.workload)
        if deployer is not None:
            tre.payload = deployer(spec)
        tre.state = TREState.CREATED
        # Step 5 (partner search): "for a new PBJ TRE, Resource Provision
        # Service will search a WS TRE from another service provider for
        # coordinated resource provisioning if a service provider allows it".
        if (spec.coordination is not CoordinationModel.NONE
                and spec.allows_foreign_coordination):
            tre.partner = self._find_partner(spec)
            if tre.partner is not None:
                self._tres[tre.partner].partner = spec.name
        return tre

    def _find_partner(self, spec: RuntimeEnvironmentSpec) -> Optional[str]:
        for name, other in self._tres.items():
            if name == spec.name or other.partner is not None:
                continue
            if other.spec.workload is spec.workload:
                continue   # coordination pairs *heterogeneous* workloads
            if other.spec.coordination is not spec.coordination:
                continue
            if not other.spec.allows_foreign_coordination:
                continue
            return name
        return None

    def activate(self, name: str, manager: object) -> TRE:
        """Steps 4–6: attach the Manager and mark the TRE running."""
        tre = self._tres[name]
        if tre.state is not TREState.CREATED:
            raise ValueError(f"TRE {name!r} is {tre.state}, expected CREATED")
        tre.manager = manager
        tre.state = TREState.RUNNING
        return tre

    def deactivate(self, name: str) -> None:
        self._tres[name].state = TREState.DEACTIVATED

    def destroy(self, name: str) -> None:
        del self._tres[name]
