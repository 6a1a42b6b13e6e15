"""DP primitives and the fused replication kernel of the port."""
