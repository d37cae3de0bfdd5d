# Copied from gatekeeper_tpu/agentaction/__init__.py; unchanged.
"""Admission control for agentic-AI tool calls (docs/targets.md).

The second `TargetHandler` implementation: tool-call / skill-invocation
records screen on the same fused kernel path, templates, analyzer,
mutation, and external-data planes as Kubernetes admission — one
engine, two targets.
"""

from .review import AgentReviewHandler, make_agent_plane  # noqa: F401
from .target import (  # noqa: F401
    AGENT_API_VERSION,
    BARE_TOOL_GROUP,
    TARGET_NAME,
    AgentAction,
    AgentActionTarget,
    SkillRecord,
    split_tool,
)
