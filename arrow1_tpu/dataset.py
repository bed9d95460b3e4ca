"""Dataset layer: multi-file discovery, partition pruning, scanning.

Reference: cpp/src/arrow/dataset/ — Dataset/Fragment (dataset.h:152,49),
Scanner/ScannerBuilder (scanner.h:241,313), Hive/directory Partitioning
with expression pruning (partition.h:59), filter+project pushdown
(scanner_internal.h:41-151).

Device shape: fragments are files; partition pruning runs host-side via
simplify_with_guarantee (exactly the reference's SimplifyWithGuarantee
pruning, expression.cc:963); surviving fragments stream through readahead
prefetch into device batches, where filter/project execute as fused device
computations.
"""

from __future__ import annotations

import dataclasses
import os
import posixpath
import re
from typing import Iterator, List, Optional, Sequence

from . import dtypes as dt
from .errors import Invalid
from .expr import Expression, FieldRef, Literal, field, literal, \
    simplify_with_guarantee
from .table import RecordBatch, Table

__all__ = ["Fragment", "FileSystemDataset", "Scanner", "ScannerBuilder",
           "HivePartitioning", "DirectoryPartitioning", "dataset",
           "write_dataset"]


@dataclasses.dataclass
class Fragment:
    """One scannable unit (reference: dataset.h:49): a file plus its
    partition guarantee expression. A non-None `filesystem` makes the
    fragment remote: bytes are fetched through the FileSystem API
    (e.g. the native WebHDFS/S3 clients) into a local spool before
    decoding, so every format reader works unchanged."""

    path: str
    format: str  # "parquet" | "ipc" | "csv" | "json" | "orc"
    partition_expression: Optional[Expression] = None
    filesystem: Optional[object] = None

    def scan_batches(self, columns=None) -> Iterator[RecordBatch]:
        from . import io as aio

        if self.filesystem is not None:
            import tempfile

            data = self.filesystem.open_input(self.path).read()
            suffix = os.path.splitext(self.path)[1]
            with tempfile.NamedTemporaryFile(suffix=suffix) as tmp:
                tmp.write(data)
                tmp.flush()
                local = dataclasses.replace(self, path=tmp.name,
                                            filesystem=None)
                yield from local.scan_batches(columns)
            return

        if self.format == "parquet":
            yield from aio.parquet.iter_parquet_batches(self.path,
                                                        columns=columns)
        elif self.format in ("ipc", "feather", "arrow"):
            for b in aio.read_ipc(self.path, batched=True):
                yield b.select(columns) if columns else b
        elif self.format == "csv":
            for b in aio.csv.open_csv_stream(self.path):
                yield b.select(columns) if columns else b
        elif self.format == "json":
            for b in aio.read_json(self.path).batches:
                yield b.select(columns) if columns else b
        elif self.format == "orc":
            from .io.orc import read_orc

            for b in read_orc(self.path,
                              columns=list(columns) if columns
                              else None).batches:
                yield b
        else:
            raise Invalid(f"unknown fragment format {self.format!r}")


class Partitioning:
    """Reference: partition.h:59."""

    def parse(self, relpath: str) -> Optional[Expression]:
        raise NotImplementedError

    def format(self, values: dict) -> str:
        raise NotImplementedError


class HivePartitioning(Partitioning):
    """key=value path segments (reference: HivePartitioning)."""

    def __init__(self, schema: Optional[dt.Schema] = None):
        self.schema = schema

    def _coerce(self, key, value):
        if self.schema is not None:
            try:
                f = self.schema.field(key)
            except KeyError:
                return value
            if f.type.is_integer:
                return int(value)
            if f.type.is_floating:
                return float(value)
        if re.fullmatch(r"-?\d+", value):
            return int(value)
        return value

    def parse(self, relpath):
        expr = None
        for seg in relpath.split(os.sep)[:-1]:
            if "=" not in seg:
                continue
            k, v = seg.split("=", 1)
            cond = field(k) == literal(self._coerce(k, v))
            expr = cond if expr is None else (expr & cond)
        return expr

    def format(self, values: dict) -> str:
        return os.sep.join(f"{k}={v}" for k, v in values.items())


class DirectoryPartitioning(Partitioning):
    """Positional path segments mapped to named fields."""

    def __init__(self, field_names: Sequence[str], schema=None):
        self.field_names = list(field_names)
        self.schema = schema

    def parse(self, relpath):
        segs = relpath.split(os.sep)[:-1]
        expr = None
        for name, seg in zip(self.field_names, segs):
            v = int(seg) if re.fullmatch(r"-?\d+", seg) else seg
            cond = field(name) == literal(v)
            expr = cond if expr is None else (expr & cond)
        return expr

    def format(self, values: dict) -> str:
        return os.sep.join(str(values[k]) for k in self.field_names)


_EXT_FORMAT = {".parquet": "parquet", ".arrow": "ipc", ".ipc": "ipc",
               ".feather": "ipc", ".csv": "csv", ".json": "json",
               ".ndjson": "json", ".orc": "orc"}


class FileSystemDataset:
    """Reference: dataset.h:152 + discovery.h FileSystemDatasetFactory."""

    def __init__(self, fragments: List[Fragment],
                 partitioning: Optional[Partitioning] = None):
        self.fragments = fragments
        self.partitioning = partitioning

    @classmethod
    def discover(cls, root: str, format: Optional[str] = None,
                 partitioning: Optional[Partitioning] = None,
                 filesystem=None) -> "FileSystemDataset":
        fragments = []
        if filesystem is not None:
            # remote discovery through the FileSystem API (reference:
            # discovery.h FileSystemDatasetFactory over a FileSystem)
            def walk(base):
                for info in filesystem.ls(base):
                    if info.is_file:
                        ext = os.path.splitext(info.path)[1]
                        fmt = format or _EXT_FORMAT.get(ext)
                        if fmt is None:
                            continue
                        rel = posixpath.relpath(info.path, root)
                        part = (partitioning.parse(rel)
                                if partitioning else None)
                        fragments.append(Fragment(info.path, fmt, part,
                                                  filesystem))
                    else:
                        walk(info.path)

            info = filesystem.get_file_info(root)
            if info.is_file:
                fmt = format or _EXT_FORMAT.get(
                    os.path.splitext(root)[1])
                return cls([Fragment(root, fmt, None, filesystem)],
                           partitioning)
            walk(root.rstrip("/"))
            fragments.sort(key=lambda f: f.path)
            return cls(fragments, partitioning)
        root = os.path.abspath(root)
        if os.path.isfile(root):
            fmt = format or _EXT_FORMAT.get(os.path.splitext(root)[1])
            return cls([Fragment(root, fmt)], partitioning)
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                ext = os.path.splitext(fname)[1]
                fmt = format or _EXT_FORMAT.get(ext)
                if fmt is None:
                    continue
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, root)
                part_expr = partitioning.parse(rel) if partitioning else None
                fragments.append(Fragment(full, fmt, part_expr))
        return cls(fragments, partitioning)

    def get_fragments(self, predicate: Optional[Expression] = None
                      ) -> List[Fragment]:
        """Partition pruning (reference: dataset.h GetFragments +
        SimplifyWithGuarantee expression.cc:963): a fragment is skipped
        when the filter simplifies to literal false under its partition
        guarantee."""
        if predicate is None:
            return list(self.fragments)
        out = []
        for frag in self.fragments:
            if frag.partition_expression is not None:
                simplified = simplify_with_guarantee(
                    predicate, frag.partition_expression)
                if isinstance(simplified, Literal) and \
                        simplified.value.is_valid and \
                        simplified.value.as_py() is False:
                    continue
            out.append(frag)
        return out

    def scanner(self, **kwargs) -> "Scanner":
        return ScannerBuilder(self).finish(**kwargs)

    # pyarrow.dataset.Dataset conveniences
    def to_table(self, **kwargs) -> Table:
        return self.scanner(**kwargs).to_table()

    def count_rows(self, **kwargs) -> int:
        return self.scanner(**kwargs).count_rows()

    def head(self, n: int, **kwargs) -> Table:
        return self.scanner(**kwargs).head(n)


@dataclasses.dataclass
class ScanOptions:
    """Reference: scanner.h:56 (+ StopToken threading, util/cancel.h)."""

    filter: Optional[Expression] = None
    columns: Optional[Sequence[str]] = None
    projection: Optional[Sequence] = None  # [(Expression, name)]
    readahead: int = 2
    fragment_readahead: int = 4  # parallel fragment decodes (scanner.cc:426)
    ordered: bool = True   # sequenced merge vs first-ready delivery
    to_device: bool = False  # device_put inside decode workers (H2D overlap)
    stop_token: Optional[object] = None  # cancel.StopToken


class Scanner:
    """Reference: scanner.h:241 — streams fragments through
    filter+project pushdown (scanner_internal.h:102
    FilterAndProjectScanTask) with readahead."""

    def __init__(self, dataset: FileSystemDataset, options: ScanOptions):
        self.dataset = dataset
        self.options = options

    def _needed_columns(self) -> Optional[List[str]]:
        opts = self.options
        if opts.projection is None and opts.columns is None:
            return None
        needed = set(opts.columns or [])
        if opts.projection:
            for e, _ in opts.projection:
                needed |= e.fields()
        if opts.filter is not None:
            needed |= opts.filter.fields()
        return sorted(needed)

    def _process_fragment(self, frag: Fragment, columns):
        """Decode + filter + project one fragment's batches, STREAMING
        (the FilterAndProjectScanTask unit, scanner_internal.h:102) —
        a generator, so a fragment's batches flow through the merged
        pipeline as they decode instead of materializing per fragment."""
        from .registry import call_function

        opts = self.options
        filt = opts.filter
        if filt is not None and frag.partition_expression is not None:
            filt = simplify_with_guarantee(filt, frag.partition_expression)
        for batch in frag.scan_batches(columns=columns):
            if opts.stop_token is not None:
                opts.stop_token.poll()
            batch = self._attach_partition_cols(batch, frag)
            if filt is not None and not (
                    isinstance(filt, Literal)
                    and filt.value.as_py() is True):
                mask = filt.execute(batch)
                batch = call_function("filter", [batch, mask])
            if opts.projection:
                cols, names = [], []
                for e, name in opts.projection:
                    cols.append(e.execute(batch))
                    names.append(name)
                batch = RecordBatch(tuple(cols), tuple(names))
            elif opts.columns:
                batch = batch.select(list(opts.columns))
            yield batch

    def scan_batches(self) -> Iterator[RecordBatch]:
        """Parallel scan: up to `fragment_readahead` fragments decode
        concurrently through per-fragment bounded queues (reference: the
        async scanner's merged generator, dataset/scanner.cc:426-650 /
        async_generator.h:1098). options.ordered picks sequenced merge
        (default) vs first-ready delivery; options.to_device moves each
        batch onto the device inside the decode worker so H2D transfer
        overlaps downstream compute (the transferred-generator analogue)."""
        from .io.prefetch import MergedIterator, ReadaheadIterator

        opts = self.options
        fragments = self.dataset.get_fragments(opts.filter)
        columns = self._needed_columns()
        if not fragments:
            return iter(())

        transfer = None
        if opts.to_device:
            import jax

            def transfer(batch):
                return jax.tree_util.tree_map(jax.device_put, batch)

        factories = [
            (lambda f=f: self._process_fragment(f, columns))
            for f in fragments]
        merged = MergedIterator(
            factories, readahead=max(1, opts.fragment_readahead),
            ordered=opts.ordered, depth=max(1, opts.readahead),
            transfer=transfer)

        def polled():
            for batch in merged:
                if opts.stop_token is not None:
                    opts.stop_token.poll()
                yield batch

        return ReadaheadIterator(polled(), self.options.readahead)

    def _attach_partition_cols(self, batch: RecordBatch, frag: Fragment):
        """Materialize partition-key columns from the fragment guarantee
        (reference: partition fields become columns at scan)."""
        expr = frag.partition_expression
        if expr is None:
            return batch
        import jax.numpy as jnp

        from .column import Column, Dictionary
        from .expr import Call
        import numpy as np

        def walk(e):
            if isinstance(e, Call) and e.function in ("and", "and_kleene"):
                for a in e.args:
                    yield from walk(a)
            elif isinstance(e, Call) and e.function == "equal":
                a, b = e.args
                if isinstance(a, FieldRef) and isinstance(b, Literal):
                    yield a.name, b.value

        out = batch
        for name, scalar_v in walk(expr):
            if name in out.names:
                continue
            v = scalar_v.as_py()
            n = batch.num_rows
            if isinstance(v, str):
                col = Column(jnp.zeros(n, jnp.int32), dt.string,
                             dictionary=Dictionary(np.array([v], dtype=object)))
            elif isinstance(v, int):
                col = Column(jnp.full(n, v, jnp.int64), dt.int64)
            elif isinstance(v, float):
                col = Column(jnp.full(n, v, jnp.float64), dt.float64)
            else:
                continue
            out = out.set_column(name, col)
        return out

    def to_table(self) -> Table:
        batches = [b for b in self.scan_batches() if b.num_rows > 0]
        if not batches:
            raise Invalid("scan produced no rows")
        return Table(batches)

    def count_rows(self) -> int:
        return sum(b.num_rows for b in self.scan_batches())

    def head(self, n: int) -> Table:
        got, total = [], 0
        for b in self.scan_batches():
            if total + b.num_rows >= n:
                got.append(b.slice(0, n - total))
                total = n
                break
            got.append(b)
            total += b.num_rows
        return Table(got)


class ScannerBuilder:
    """Reference: scanner.h:313."""

    def __init__(self, dataset: FileSystemDataset):
        self.dataset = dataset
        self._options = ScanOptions()

    def filter(self, expr: Expression) -> "ScannerBuilder":
        self._options.filter = expr
        return self

    def project(self, exprs, names=None) -> "ScannerBuilder":
        if names is None:  # plain column selection
            self._options.columns = list(exprs)
        else:
            self._options.projection = list(zip(exprs, names))
        return self

    def readahead(self, n: int) -> "ScannerBuilder":
        self._options.readahead = n
        return self

    def finish(self, **kwargs) -> Scanner:
        for k, v in kwargs.items():
            setattr(self._options, k, v)
        return Scanner(self.dataset, self._options)


def dataset(root, format=None, partitioning=None, filesystem=None,
            **kwargs) -> FileSystemDataset:
    """pyarrow.dataset.dataset shape: path / list of paths / Table /
    batches / datasets; format as string or FileFormat; partitioning as
    flavor string, Partitioning, or PartitioningFactory. URI roots
    (hdfs:// / webhdfs:// / s3:// / mock://) and explicit filesystem=
    dispatch through the FileSystem API (native WebHDFS/S3 clients)."""
    if partitioning == "hive":  # pyarrow accepts the flavor as a string
        partitioning = HivePartitioning()
    elif isinstance(partitioning, PartitioningFactory):
        partitioning = partitioning.finish()
    fmt = format.name if isinstance(format, FileFormat) else format
    if isinstance(root, str) and "://" in root \
            and not root.startswith("file://"):
        from .fs import filesystem_from_uri

        fs, base = filesystem_from_uri(root)
        return FileSystemDataset.discover(base, fmt, partitioning,
                                          filesystem=fs)
    if filesystem is not None and isinstance(root, str):
        return FileSystemDataset.discover(root, fmt, partitioning,
                                          filesystem=filesystem)
    if isinstance(root, Table) or (
            isinstance(root, (list, tuple)) and root
            and isinstance(root[0], (Table, RecordBatch))):
        return InMemoryDataset(root)
    if isinstance(root, FileSystemDataset):
        return root
    if isinstance(root, (list, tuple)):
        if root and isinstance(root[0], FileSystemDataset):
            return UnionDataset(children=root)
        frags = [Fragment(os.path.abspath(p),
                          fmt or _EXT_FORMAT.get(os.path.splitext(p)[1]))
                 for p in root]
        return FileSystemDataset(frags, None)
    return FileSystemDataset.discover(root, fmt, partitioning)


def write_dataset(data, root: str, partitioning_keys: Sequence[str] = (),
                  format: str = "parquet",
                  partitioning: Optional[Partitioning] = None):
    """Partitioned dataset write (reference: dataset/file_base.h:283
    FileSystemDataset::Write). Splits rows by partition-key values and
    writes one file per partition directory."""
    from . import io as aio
    from .ops.groupby import group_by
    from .registry import call_function
    import numpy as np

    batch = data.combine_chunks() if isinstance(data, Table) else data
    os.makedirs(root, exist_ok=True)
    writer = {"parquet": aio.write_parquet, "ipc": aio.write_ipc,
              "csv": aio.write_csv, "orc": aio.write_orc}[format]
    ext = {"parquet": ".parquet", "ipc": ".arrow", "csv": ".csv",
           "orc": ".orc"}[format]
    if not partitioning_keys:
        writer(batch, os.path.join(root, f"part-0{ext}"))
        return
    part = partitioning or HivePartitioning()
    # distinct key combos host-side (partition counts are small)
    arrs = {k: batch.column(k).to_numpy() for k in partitioning_keys}
    combos = sorted({tuple(arrs[k][i] for k in partitioning_keys)
                     for i in range(batch.num_rows)}, key=repr)
    # per-partition FILE WRITES ride the host thread pool (the reference
    # writes fragments on the CPU pool, file_base.cc WriteInternal); the
    # device-side filter stays on the main thread.
    from .thread_pool import TaskGroup

    tg = TaskGroup(threaded=len(combos) > 1)
    for i, combo in enumerate(combos):
        pred = None
        values = {}
        for k, v in zip(partitioning_keys, combo):
            v = v.item() if hasattr(v, "item") else v
            values[k] = v
            cond = field(k) == literal(v)
            pred = cond if pred is None else (pred & cond)
        mask = pred.execute(batch)
        sub = call_function("filter", [batch, mask])
        subdir = os.path.join(root, part.format(values))
        os.makedirs(subdir, exist_ok=True)
        tg.append(writer, sub.drop(list(partitioning_keys)),
                  os.path.join(subdir, f"part-{i}{ext}"))
    tg.finish()


# ====================================================================
# pyarrow.dataset namespace parity (python/pyarrow/dataset.py surface)
# ====================================================================

Dataset = FileSystemDataset          # pyarrow class-name aliases
FileFragment = Fragment
ParquetFileFragment = Fragment
FileStats = None  # removed in pyarrow too; kept for dir() parity


class FileFormat:
    """Reference: file_base.h FileFormat — format marker carrying the
    discovery extension; our fragments dispatch on the name string."""

    name = ""
    default_extname = ""

    def __eq__(self, other):
        return isinstance(other, FileFormat) and self.name == other.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"<{type(self).__name__}>"


class ParquetFileFormat(FileFormat):
    name = "parquet"
    default_extname = "parquet"

    def __init__(self, read_options=None, default_fragment_scan_options=None,
                 **kwargs):
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class IpcFileFormat(FileFormat):
    name = "ipc"
    default_extname = "arrow"


class FeatherFileFormat(IpcFileFormat):
    default_extname = "feather"


class CsvFileFormat(FileFormat):
    name = "csv"
    default_extname = "csv"

    def __init__(self, parse_options=None, convert_options=None,
                 read_options=None, default_fragment_scan_options=None):
        self.parse_options = parse_options
        self.convert_options = convert_options
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class JsonFileFormat(FileFormat):
    name = "json"
    default_extname = "json"

    def __init__(self, parse_options=None, read_options=None,
                 default_fragment_scan_options=None):
        self.parse_options = parse_options
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class OrcFileFormat(FileFormat):
    name = "orc"
    default_extname = "orc"


def _format_name(format) -> Optional[str]:
    """Accept a format string or a FileFormat instance."""
    if format is None:
        return None
    return format.name if isinstance(format, FileFormat) else str(format)


class FilenamePartitioning(Partitioning):
    """Underscore-separated values prefixed to the FILENAME
    (reference: partition.h FilenamePartitioning:
    '<val>_<val>_<rest>')."""

    def __init__(self, field_names: Sequence[str] = (), schema=None):
        self.field_names = list(field_names) if field_names else \
            [f.name for f in schema.fields] if schema is not None else []
        self.schema = schema

    def parse(self, relpath):
        fname = os.path.basename(relpath)
        segs = fname.split("_")[: len(self.field_names)]
        expr = None
        for name, seg in zip(self.field_names, segs):
            v = int(seg) if re.fullmatch(r"-?\d+", seg) else seg
            cond = field(name) == literal(v)
            expr = cond if expr is None else (expr & cond)
        return expr

    def format(self, values: dict) -> str:
        return "_".join(str(values[k]) for k in self.field_names) + "_"


class PartitioningFactory:
    """Deferred partitioning: field names known, value types inferred at
    discovery (reference: partition.h PartitioningFactory)."""

    def __init__(self, kind: str, field_names=()):
        self.kind = kind
        self.field_names = list(field_names)

    def finish(self, schema=None) -> Partitioning:
        if self.kind == "hive":
            return HivePartitioning(schema)
        if self.kind == "filename":
            return FilenamePartitioning(self.field_names, schema)
        return DirectoryPartitioning(self.field_names, schema)


def partitioning(schema=None, field_names=None, flavor=None,
                 dictionaries=None):
    """pyarrow.dataset.partitioning factory: flavor None -> directory,
    'hive' -> hive, 'filename' -> filename."""
    if flavor == "hive":
        return HivePartitioning(schema)
    if flavor == "filename":
        names = field_names or ([f.name for f in schema.fields]
                                if schema is not None else [])
        return FilenamePartitioning(names, schema)
    if field_names is None and schema is None:
        raise Invalid("partitioning needs schema or field_names")
    names = field_names or [f.name for f in schema.fields]
    return DirectoryPartitioning(names, schema)


def scalar(value):
    """pyarrow.dataset.scalar -> expression literal."""
    return literal(value)


def get_partition_keys(partition_expression) -> dict:
    """Extract {field: value} from a conjunction of equality expressions
    (reference: partition.cc GetPartitionKeys)."""
    from .expr import Call, FieldRef, Literal as _Lit

    out = {}

    def walk(e):
        if isinstance(e, Call):
            if e.function in ("and", "and_kleene"):
                for a in e.args:
                    walk(a)
            elif e.function == "equal" and len(e.args) == 2:
                lhs, rhs = e.args
                if isinstance(lhs, FieldRef) and isinstance(rhs, _Lit):
                    out[lhs.name] = rhs.value.as_py()
                elif isinstance(rhs, FieldRef) and isinstance(lhs, _Lit):
                    out[rhs.name] = lhs.value.as_py()

    if partition_expression is not None:
        walk(partition_expression)
    return out


class _MemoryFragment(Fragment):
    """In-memory fragment: batches already resident."""

    def __init__(self, batches, partition_expression=None):
        super().__init__(path="<memory>", format="memory",
                         partition_expression=partition_expression)
        self._batches = list(batches)

    def scan_batches(self, columns=None):
        for b in self._batches:
            yield b.select(list(columns)) if columns else b


class InMemoryDataset(FileSystemDataset):
    """Dataset over resident tables/batches
    (reference: dataset.h InMemoryDataset)."""

    def __init__(self, source, schema=None):
        batches = []
        items = source if isinstance(source, (list, tuple)) else [source]
        for item in items:
            if isinstance(item, Table):
                batches.extend(item.batches)
            else:
                batches.append(item)
        super().__init__([_MemoryFragment(batches)], None)


class UnionDataset(FileSystemDataset):
    """Concatenation of child datasets (reference: UnionDataset)."""

    def __init__(self, schema=None, children=()):
        self.children = list(children)
        frags = []
        for ch in self.children:
            frags.extend(ch.fragments)
        super().__init__(frags, None)


class TaggedRecordBatch:
    """(record_batch, fragment) pair yielded by scan_batches
    (reference: scanner.h TaggedRecordBatch)."""

    __slots__ = ("record_batch", "fragment")

    def __init__(self, record_batch, fragment):
        self.record_batch = record_batch
        self.fragment = fragment


@dataclasses.dataclass
class FileSystemFactoryOptions:
    """Reference: discovery.h FileSystemFactoryOptions."""
    partition_base_dir: str = ""
    partitioning: Optional[object] = None
    exclude_invalid_files: bool = False
    selector_ignore_prefixes: Sequence[str] = (".", "_")


class DatasetFactory:
    """Deferred dataset construction (reference: discovery.h)."""

    def __init__(self, finish_fn):
        self._finish = finish_fn

    def finish(self, schema=None):
        return self._finish()

    def inspect(self):
        ds = self.finish()
        t = ds.head(1)
        return t.schema


class FileSystemDatasetFactory(DatasetFactory):
    def __init__(self, filesystem, paths_or_selector, format,
                 options: Optional[FileSystemFactoryOptions] = None):
        fmt = _format_name(format)
        opts = options or FileSystemFactoryOptions()
        part = opts.partitioning

        def finish():
            if isinstance(paths_or_selector, (list, tuple)):
                frags = [Fragment(p, fmt or _EXT_FORMAT.get(
                    os.path.splitext(p)[1])) for p in paths_or_selector]
                return FileSystemDataset(frags, None)
            base = getattr(paths_or_selector, "base_dir",
                           paths_or_selector)
            p = part.finish() if isinstance(part, PartitioningFactory) \
                else part
            return FileSystemDataset.discover(base, fmt, p)

        super().__init__(finish)


class UnionDatasetFactory(DatasetFactory):
    def __init__(self, factories):
        super().__init__(
            lambda: UnionDataset(children=[f.finish() for f in factories]))


def parquet_dataset(metadata_path, schema=None, filesystem=None,
                    format=None, partitioning=None):
    """pyarrow.dataset.parquet_dataset: dataset from a _metadata file's
    directory (row-group level metadata collapses to file scan here)."""
    return dataset(os.path.dirname(os.path.abspath(metadata_path)),
                   format="parquet", partitioning=partitioning)


# ---- scan/write option classes (shape parity; the scanner consumes
# plain ScanOptions internally) ----

@dataclasses.dataclass
class FragmentScanOptions:
    pass


@dataclasses.dataclass
class CsvFragmentScanOptions(FragmentScanOptions):
    convert_options: Optional[object] = None
    read_options: Optional[object] = None


@dataclasses.dataclass
class JsonFragmentScanOptions(FragmentScanOptions):
    parse_options: Optional[object] = None
    read_options: Optional[object] = None


@dataclasses.dataclass
class ParquetFragmentScanOptions(FragmentScanOptions):
    use_buffered_stream: bool = False
    buffer_size: int = 8192
    pre_buffer: bool = True


@dataclasses.dataclass
class ParquetReadOptions:
    dictionary_columns: Sequence[str] = ()
    coerce_int96_timestamp_unit: Optional[str] = None


@dataclasses.dataclass
class FileWriteOptions:
    format: Optional[object] = None


@dataclasses.dataclass
class ParquetFileWriteOptions(FileWriteOptions):
    compression: str = "snappy"


@dataclasses.dataclass
class IpcFileWriteOptions(FileWriteOptions):
    compression: Optional[str] = None


@dataclasses.dataclass
class WrittenFile:
    """Reference: file_base.h FileWriter metadata callback payload."""
    path: str
    metadata: Optional[object] = None
    size: int = 0


@dataclasses.dataclass
class RowGroupInfo:
    id: int = 0
    metadata: Optional[object] = None
    schema: Optional[object] = None
    num_rows: int = 0
    total_byte_size: int = 0


@dataclasses.dataclass
class ParquetEncryptionConfig:
    crypto_factory: Optional[object] = None
    kms_connection_config: Optional[object] = None
    encryption_config: Optional[object] = None


@dataclasses.dataclass
class ParquetDecryptionConfig:
    crypto_factory: Optional[object] = None
    kms_connection_config: Optional[object] = None
    decryption_config: Optional[object] = None


@dataclasses.dataclass
class ParquetFactoryOptions:
    partition_base_dir: str = ""
    partitioning: Optional[object] = None
    validate_column_chunk_paths: bool = False


class ParquetDatasetFactory(DatasetFactory):
    """Dataset from a parquet _metadata file (reference:
    discovery.h ParquetDatasetFactory)."""

    def __init__(self, metadata_path, filesystem=None, format=None,
                 options: Optional[ParquetFactoryOptions] = None):
        super().__init__(lambda: parquet_dataset(metadata_path))
