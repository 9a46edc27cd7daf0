"""Static resource models shared by the runtime fallback predicates."""
