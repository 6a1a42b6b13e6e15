"""R serialization (RDS) for the grid's tables, numpy only."""
