"""Graph containers, frontiers, operators, the ALB planner and round."""
