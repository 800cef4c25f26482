"""AcceleratorManager ABC.

Counterpart of the reference's python/ray/_private/accelerators/
accelerator.py: one manager per accelerator family, answering "how many
on this node", "what type", "what extra scheduling resources", and
"constrain visibility for a worker".
"""

from __future__ import annotations

from typing import Dict, List, Optional


class AcceleratorManager:
    """One accelerator family's detection + environment shaping."""

    # The scheduler resource name, e.g. "GPU".
    resource_name: str = ""

    def get_num_accelerators(self) -> int:
        """Accelerators visible on this node (0 if none)."""
        raise NotImplementedError

    def get_accelerator_type(self) -> Optional[str]:
        """Family/type string (e.g. "H100"), or None if undetectable."""
        return None

    def get_additional_resources(self) -> Dict[str, float]:
        """Extra node resources beyond the plain count (e.g. the
        reference's `accelerator_type:H100` marker)."""
        return {}

    def get_visibility_env(self, ids: List[int]) -> Dict[str, str]:
        """Env vars that restrict a worker process to the given
        accelerator ids (the reference's set_current_process_visible_
        accelerator_ids)."""
        return {}

    def validate_resource_request_quantity(self, quantity: float
                                           ) -> Optional[str]:
        """Return an error string if the request is invalid."""
        return None
