"""The yardstick's code: traffic, load generation, the wire, the replica, the
device-trace reduction and the comparison that decides `correct`."""
