"""The port's configurations (its own copies; nothing imported from repro)."""
