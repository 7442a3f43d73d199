"""What the benchmark measures against: the card's published peaks
(`peaks`), the work the step needs counted from its inputs (`work`, with
frozen copies of the port's kernel work formulas), and the arithmetic that
turns a profiler trace into busy time, idle gaps and kernel time
(`trace`)."""
