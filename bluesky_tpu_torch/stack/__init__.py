"""The text command stack — the universal user/API surface."""
