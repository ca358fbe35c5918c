"""Core: PQ sub-id retrieval and PQTopK scoring."""
