"""Problem families: the spatial-operator axis (the port of
``heat2d_tpu/problems/``). ``base`` is the declarative half (specs,
capability gates), ``registry`` binds each spec to its plain updates,
``runners`` runs batches of a family through the kernel routes."""

from heat2d_tpu_torch.problems.base import (FAMILY_SPECS, FamilySpec,
                                            capability_matrix, spec_for,
                                            supports_method)
from heat2d_tpu_torch.problems.registry import (Family, family_names,
                                                get_family, register)

__all__ = ["FAMILY_SPECS", "Family", "FamilySpec", "capability_matrix",
           "family_names", "get_family", "register", "spec_for",
           "supports_method"]
