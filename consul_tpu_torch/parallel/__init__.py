"""The port's program contracts: the registry of entry points and its rules
(kernel_audit) and the check command that measures and judges them
(kernel_lint)."""
