# Copied from gatekeeper_tpu/agentaction/target.py; unchanged.
"""AgentActionTarget: admission control for agentic-AI tool calls.

The second TargetHandler implementation (ROADMAP item 4; docs/
targets.md) — proof that the constraint engine is generic. A tool-call
/ skill-invocation record (agent id, session, tool name, arguments,
declared capabilities, skill provenance) normalizes into the engine's
internal review vocabulary, and the target's public match schema —
tool globs, agent selectors, capability/skill label selectors —
translates into the internal match-block vocabulary. From there the
ENTIRE stack is reused unchanged: the vectorized match kernel screens
thousands of concurrent agent actions per fused dispatch, templates
compile through the same analyzer + symbolic compiler, mutation
rewrites tool-call arguments the way Assign rewrites a pod, and
external-data providers answer skill-registry/signature lookups with
the per-batch dedupe + cache.

The normalization (the review "IR"):

  * tool name `ns.leaf` -> review.kind {group: "ns", kind: "leaf"}
    (dotless tools get the reserved group "tool"), so `match.tools`
    globs — `*`, `ns.*`, exact — compile EXACTLY onto the kernel's
    kind-selector rows;
  * agent id -> review.namespace, so `match.agents` /
    `match.excludedAgents` ride the namespaces membership tensors;
  * declared capabilities -> object labels, so `match.capabilities` is
    a labelSelector;
  * skill provenance -> the attached review-context object's labels
    (`_unstable.namespace`), so `match.skills` is a namespaceSelector
    resolved without any synced cache — the context always rides the
    review, which is also why agent reviews can never autoreject.

Template Rego sees `input.review.object.spec.{tool,agent,session,
arguments,capabilities,skill}` plus the capability labels at
`input.review.object.metadata.labels`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..constraint.errors import InvalidConstraintError
from ..constraint.handler import (
    TargetHandler,
    WipeData,
    label_selector_schema,
    validate_label_selector,
)
from ..constraint.types import Result

TARGET_NAME = "agent.action.gatekeeper.sh"
AGENT_API_VERSION = "agentaction.gatekeeper.sh/v1"

# the kind-selector group for dotless tool names; also what keeps an
# agent review from ever colliding with the engine's reserved
# {group: "", kind: "Namespace"} shape
BARE_TOOL_GROUP = "tool"

_SCALARS = (str, int, float, bool)


@dataclass
class AgentAction:
    """One tool call / skill invocation awaiting review."""

    agent: str
    tool: str
    session: str = ""
    arguments: Dict[str, Any] = field(default_factory=dict)
    capabilities: Any = None  # list of names or {name: value} labels
    skill: Optional[Dict[str, Any]] = None  # provenance record
    id: str = ""

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "AgentAction":
        rec = rec if isinstance(rec, dict) else {}
        return cls(
            agent=str(rec.get("agent") or ""),
            tool=str(rec.get("tool") or ""),
            session=str(rec.get("session") or ""),
            arguments=(
                rec.get("arguments")
                if isinstance(rec.get("arguments"), dict)
                else {}
            ),
            capabilities=rec.get("capabilities"),
            skill=(
                rec.get("skill") if isinstance(rec.get("skill"), dict) else None
            ),
            id=str(rec.get("id") or rec.get("uid") or ""),
        )

    def to_record(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "agent": self.agent,
            "tool": self.tool,
            "session": self.session,
            "arguments": self.arguments,
        }
        if self.capabilities is not None:
            out["capabilities"] = self.capabilities
        if self.skill is not None:
            out["skill"] = self.skill
        if self.id:
            out["id"] = self.id
        return out


@dataclass
class SkillRecord:
    """A skill-registry entry synced into the target's data tree
    (data.inventory reads + future context lookups)."""

    name: str
    labels: Dict[str, Any] = field(default_factory=dict)


def split_tool(tool: str) -> Tuple[str, str]:
    """Tool name -> (group, leaf): the first "." is the namespace
    boundary; dotless names get the reserved group."""
    if "." in tool:
        group, leaf = tool.split(".", 1)
        return group, leaf
    return BARE_TOOL_GROUP, tool


def _glob_kind_selector(entry: Any) -> Dict[str, Any]:
    """One `tools` glob -> one internal kind-selector row. The grammar
    is exactly what the kernel's (group, kind) rows express losslessly:
    "*" (everything), "ns.*" (a tool namespace), or an exact name.
    Anything else translates to a row that can never match (and
    validate_constraint rejects it up front)."""
    if not isinstance(entry, str):
        return {"apiGroups": [], "kinds": []}
    if entry == "*":
        return {"apiGroups": ["*"], "kinds": ["*"]}
    if entry.endswith(".*"):
        ns = entry[:-2]
        if ns and "*" not in ns and "?" not in ns and "." not in ns:
            return {"apiGroups": [ns], "kinds": ["*"]}
        return {"apiGroups": [], "kinds": []}
    if "*" in entry or "?" in entry:
        return {"apiGroups": [], "kinds": []}
    group, leaf = split_tool(entry)
    return {"apiGroups": [group], "kinds": [leaf]}


def _glob_valid(entry: Any) -> bool:
    if not isinstance(entry, str):
        return False
    if entry == "*":
        return True
    if entry.endswith(".*"):
        ns = entry[:-2]
        return bool(ns) and "*" not in ns and "?" not in ns and "." not in ns
    return "*" not in entry and "?" not in entry and bool(entry)


def _capability_labels(capabilities: Any) -> Dict[str, Any]:
    if isinstance(capabilities, dict):
        return {str(k): v for k, v in capabilities.items()}
    if isinstance(capabilities, (list, tuple)):
        return {str(c): "true" for c in capabilities}
    return {}


def _skill_labels(skill: Dict[str, Any]) -> Dict[str, Any]:
    """Scalar provenance fields become selector-matchable labels."""
    return {
        str(k): v
        for k, v in skill.items()
        if isinstance(v, _SCALARS) or v is None
    }


class AgentActionTarget(TargetHandler):
    """TargetHandler for agent tool-call screening."""

    def get_name(self) -> str:
        return TARGET_NAME

    # -- normalization -------------------------------------------------------

    def review_of(self, record: Any) -> Dict[str, Any]:
        """Tool-call record -> internal review. The one normalization
        every plane shares (serving, audit listing, mutation screen)."""
        if isinstance(record, AgentAction):
            rec = record.to_record()
        elif isinstance(record, dict):
            rec = record
        else:
            rec = {}
        tool = str(rec.get("tool") or "")
        group, leaf = split_tool(tool)
        agent = str(rec.get("agent") or "")
        session = str(rec.get("session") or "")
        action_id = str(rec.get("id") or rec.get("uid") or "")
        cap_labels = _capability_labels(rec.get("capabilities"))
        skill = rec.get("skill") if isinstance(rec.get("skill"), dict) else {}
        arguments = (
            rec.get("arguments") if isinstance(rec.get("arguments"), dict)
            else {}
        )
        name = action_id or tool
        obj = {
            "apiVersion": f"{group}/v1",
            "kind": leaf,
            "metadata": {
                "name": name,
                "namespace": agent,
                "labels": cap_labels,
            },
            "spec": {
                "tool": tool,
                "agent": agent,
                "session": session,
                "arguments": arguments,
                "capabilities": rec.get("capabilities"),
                "skill": skill,
            },
        }
        return {
            "uid": action_id,
            "kind": {"group": group, "version": "v1", "kind": leaf},
            "operation": "CALL",
            "name": name,
            "namespace": agent,
            "userInfo": {"username": agent},
            "object": obj,
            # the skill-provenance context ALWAYS rides the review:
            # match.skills resolves against it with no synced cache,
            # and its presence is what makes autoreject structurally
            # impossible for agent reviews
            "_unstable": {
                "namespace": {
                    "metadata": {
                        "name": str(skill.get("name") or ""),
                        "labels": _skill_labels(skill),
                    }
                }
            },
        }

    # -- data ingestion ------------------------------------------------------

    def process_data(self, obj: Any) -> Tuple[bool, str, Any]:
        """Actions land under actions/<session>/<id> (the audit
        corpus), skill-registry entries under skills/<name>."""
        if isinstance(obj, WipeData) or obj is WipeData:
            return True, "", None
        if isinstance(obj, AgentAction):
            if not obj.tool:
                raise ValueError("agent action has no tool")
            key = obj.id or obj.tool
            return (
                True,
                f"actions/{obj.session or '-'}/{key}",
                obj.to_record(),
            )
        if isinstance(obj, SkillRecord):
            if not obj.name:
                raise ValueError("skill record has no name")
            return (
                True,
                f"skills/{obj.name}",
                {"name": obj.name, "labels": dict(obj.labels)},
            )
        return False, "", None

    # -- review normalization ------------------------------------------------

    def handle_review(self, obj: Any) -> Tuple[bool, Any]:
        """Claims AgentAction objects and raw record dicts that
        self-identify (kind: AgentAction); everything else is another
        target's."""
        if isinstance(obj, AgentAction):
            return True, self.review_of(obj)
        if isinstance(obj, dict) and obj.get("kind") == "AgentAction":
            return True, self.review_of(obj.get("spec") or obj)
        return False, None

    # -- violation post-processing -------------------------------------------

    def handle_violation(self, result: Result) -> None:
        review = result.review
        if not isinstance(review, dict):
            raise ValueError(f"could not cast review as map: {review!r}")
        obj = review.get("object")
        spec = obj.get("spec") if isinstance(obj, dict) else None
        if not isinstance(spec, dict):
            raise ValueError("no action object returned in review")
        result.resource = {
            "apiVersion": AGENT_API_VERSION,
            "kind": "AgentAction",
            "metadata": {
                "name": review.get("name", ""),
                "agent": spec.get("agent", ""),
                "session": spec.get("session", ""),
            },
            "spec": dict(spec),
        }

    # -- match schema + validation -------------------------------------------

    def match_schema(self) -> Dict[str, Any]:
        string_list = {"type": "array", "items": {"type": "string"}}
        selector = label_selector_schema()
        return {
            "type": "object",
            "properties": {
                "tools": string_list,
                "agents": string_list,
                "excludedAgents": string_list,
                "capabilities": selector,
                "skills": selector,
            },
        }

    def validate_constraint(self, constraint: Dict[str, Any]) -> None:
        spec = constraint.get("spec")
        match = spec.get("match") if isinstance(spec, dict) else None
        if not isinstance(match, dict):
            return
        tools = match.get("tools")
        if isinstance(tools, list):
            for t in tools:
                if not _glob_valid(t):
                    raise InvalidConstraintError(
                        f"match.tools: unsupported tool glob {t!r} "
                        f"(supported: '*', '<ns>.*', exact names)"
                    )
        for sel_field in ("capabilities", "skills"):
            selector = match.get(sel_field)
            if isinstance(selector, dict):
                validate_label_selector(selector, f"match.{sel_field}")
        for list_field in ("agents", "excludedAgents"):
            ids = match.get(list_field)
            if isinstance(ids, list):
                for a in ids:
                    if not isinstance(a, str):
                        raise InvalidConstraintError(
                            f"match.{list_field}: agent ids must be "
                            f"strings, got {a!r}"
                        )

    # -- schema translation (the engine-facing boundary) ---------------------

    def match_ir(self, constraint: Dict[str, Any]) -> Any:
        """Agent match schema -> the engine's internal match-block
        vocabulary. Shallow: raw sub-values pass through so the
        engine's edge-case semantics (non-list fields, null entries)
        stay byte-identical between oracle and kernel."""
        from ..constraint.hooks import constraint_match

        match = constraint_match(constraint)
        if not isinstance(match, dict):
            return match
        out: Dict[str, Any] = {}
        if "tools" in match:
            tools = match["tools"]
            out["kinds"] = (
                [_glob_kind_selector(t) for t in tools]
                if isinstance(tools, list)
                else tools
            )
        if "agents" in match:
            out["namespaces"] = match["agents"]
        if "excludedAgents" in match:
            out["excludedNamespaces"] = match["excludedAgents"]
        if "capabilities" in match:
            out["labelSelector"] = match["capabilities"]
        if "skills" in match:
            out["namespaceSelector"] = match["skills"]
        return out

    # -- audit listing -------------------------------------------------------

    def iter_cached_reviews(self, external: Any) -> Iterator[Any]:
        """Reviews for every synced action record — each re-normalized
        through review_of so audit sees exactly the serving shape."""
        if not isinstance(external, dict):
            return
        actions = external.get("actions")
        if not isinstance(actions, dict):
            return
        for session in sorted(actions):
            by_id = actions[session]
            if not isinstance(by_id, dict):
                continue
            for _aid, rec in sorted(by_id.items()):
                if isinstance(rec, dict):
                    yield self.review_of(rec)

    def wrap_audit_object(self, obj: Any, context: Any = None) -> Any:
        return AgentAction.from_record(obj) if isinstance(obj, dict) else obj

    # -- webhook plane -------------------------------------------------------

    def augment_request(
        self,
        request: Dict[str, Any],
        context_getter: Optional[Callable[[str], Optional[dict]]] = None,
    ) -> Any:
        """/v1/agent/review request body -> AgentAction (the skill
        context is intrinsic to the record; no getter needed)."""
        return AgentAction.from_record(request)

    def sample_requests(self, n: int) -> List[Dict[str, Any]]:
        """Warmup tool calls covering both capability-label shape
        buckets; synthetic keys never reach a provider (the driver's
        warm path pins coarse external-data bits)."""
        out = []
        for i in range(n):
            out.append(
                {
                    "id": f"warmup-{i}",
                    "agent": "system:warmup",
                    "session": "warmup",
                    "tool": ["shell.exec", "net.fetch"][i % 2],
                    "arguments": {"arg": f"v{i}"},
                    "capabilities": [f"cap{j}" for j in range(1 + (i % 2) * 7)],
                    "skill": {
                        "name": "warmup-skill",
                        "signed": True,
                        "publisher": "warmup",
                    },
                }
            )
        return out
