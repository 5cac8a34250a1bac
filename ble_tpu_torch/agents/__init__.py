"""Agent registry (the port of ble_tpu/agents/__init__.py; reference
agents/agent_registry.py:40-75). The agent modules register themselves
when create_agent or available_agents first needs them (base.py)."""

from ble_tpu_torch.agents import base

available_agents = base.available_agents
create_agent = base.create_agent
