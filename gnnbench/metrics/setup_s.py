"""setup_s: from the process's start to the window's: imports, inputs,
the program's build (partition included) and the checked first steps,
which warm every shape the window runs."""


def read(ctx):
    return ctx["setup_s"]
