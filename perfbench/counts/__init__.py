"""The yardstick's counts: operations and bytes from shapes, and the
card's published peaks."""
