"""Serving: the paged KV-cache manager (the paper's cost-based eviction
over prompt pages), the serve and prefill steps, and the slot-batched
decode engine."""
