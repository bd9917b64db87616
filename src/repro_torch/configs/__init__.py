# The paper's GraphSAGE presets and the serving configuration built on them.
