"""Protocol core of the port: schedules, optimizer, rounds, topology, fed."""
