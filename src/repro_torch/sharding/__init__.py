from repro_torch.sharding.partition import MeshPlan, NULL_PLAN

__all__ = ["MeshPlan", "NULL_PLAN"]
