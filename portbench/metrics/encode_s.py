"""encode_s: seconds of the parity encode in set-up (the program's span
``encode/parity``, which waits for the card), or nothing where the scheme
encodes no parity."""


def read(ctx):
    return ctx.spans.get("encode/parity")
